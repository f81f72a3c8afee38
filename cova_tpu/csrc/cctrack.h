// Host-side connected components + SORT tracker (C ABI).
//
// The reference runs both on CPU (bboxcc's OpenCV connected components,
// cova-rs/sort's Kalman+Hungarian, cova's tracker.rs seen/min_required
// bookkeeping); the accelerator keeps the dense FLOPs (BlobNet) and this module
// keeps the branchy integer control logic where it is fastest. The JAX
// implementations (cova_tpu/ops/cc.py, cova_tpu/tracker/) remain the
// all-device variants used by the sharded multi-chip path and tests;
// tests/test_cctrack.py pins this module against them differentially.
#pragma once

#include <cstdint>

extern "C" {

// 8-connected components over F mask frames; per frame emits up to
// max_boxes component bounding boxes with pixel area >= area_threshold,
// in OpenCV label order (raster order of each component's first pixel)
// — reference: cova-rs/gst-plugins/src/bboxcc/process.rs:5-49.
// masks: F*H*W u8 (0 background); ltwh_out: F*K*4 f32; area_out: F*K
// f32 (box w*h, the reference's Bbox::new area); valid_out: F*K u8.
int cova_cc_boxes(const uint8_t* masks, int f, int h, int w,
                  int area_threshold, int max_boxes, float* ltwh_out,
                  float* area_out, uint8_t* valid_out);

// SORT tracker with the cova element's seen/min_required bookkeeping.
void* cova_sort_new(float iou_threshold, int max_age, int min_hits,
                    int from_x_quirk);
void cova_sort_free(void* h);

// One frame update. ltwh: n*4 f32 detections. Returns the number of
// dead tracks REPORTED this frame (active deaths only; drain them with
// cova_sort_dead_*). min_required_out: max start-ts over dead-and-
// unseen tracks; 0 when tracks died but all were seen; NaN when no
// track died (reference: cova/tracker.rs:43-60).
int cova_sort_update(void* h, const float* ltwh, int n, double ts,
                     double* min_required_out);

// Batched frame updates for callers without per-frame scheduling
// feedback (the bench / standalone tracking pipeline): for each frame
// i in 0..f-1 at ts = ts0 + i*step, update with frame i's valid
// detections from a fixed-capacity (f, k) grid — ltwh: f*k*4 f32,
// valid: f*k u8. Per-frame min_required is not surfaced (that is the
// cova selector's feedback channel; it calls cova_sort_update per
// frame). Returns the total dead-track count reported across the
// batch; drain once with cova_sort_dead_*.
int cova_sort_update_batch(void* h, const float* ltwh,
                           const uint8_t* valid, int f, int k,
                           double ts0, double step);

// A decode was scheduled at `ts`: all live tracks record it
// (reference: Sort::mark_seen, lib.rs:198-201).
void cova_sort_mark_seen(void* h, double ts);

// Min start-ts over live tracks, +inf when none (tracker.rs
// get_oldest_timestamp).
double cova_sort_oldest(void* h);

// EOS: report remaining active tracks with history > min_hits
// (Sort::finalize, lib.rs:207-213). Returns the number appended to the
// dead list.
int cova_sort_finalize(void* h);

// Drain reported dead tracks (accumulated across updates until
// cova_sort_drain).
int cova_sort_dead_count(void* h);
void cova_sort_dead_info(void* h, int i, int32_t* track_id,
                         double* start_ts, double* end_ts, int32_t* seen,
                         int32_t* hist_len);
void cova_sort_dead_history(void* h, int i, double* ts_out,
                            float* ltwh_out);
void cova_sort_drain(void* h);

}  // extern "C"
