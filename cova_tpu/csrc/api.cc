// C API for ctypes binding (cova_tpu/codec/__init__.py).
//
// Replaces the reference's GStreamer element graph plumbing with three
// host-side services (selective pixel decode lives in pixdec.cc):
//   * MP4 demux + GoP index       (reference: qtdemux/h264parse/gopsplit)
//   * batch entropy decode        (reference: 32x patched avdec_h264)
// Batch entropy decode is parallel at GoP granularity — the reference's
// gopsplit fan-out (gstgopsplit.cpp:501-661): within a GoP, frames
// decode sequentially in decode order so the decoder's DPB holds the
// co-located reference pictures that exact B-direct motion-vector
// export needs (entdec.cc, 8.4.1.2). Per-GoP decoder state is cached on
// the handle, so a caller streaming consecutive chunks of a GoP never
// re-decodes its prefix.

#include <algorithm>
#include <atomic>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include "entdec.h"
#include "mp4.h"

using namespace cova;

namespace {

struct GopDecoderState {
  std::unique_ptr<EntropyDecoder> dec;
  uint32_t next = 0;   // absolute index of the next sample to decode
  bool in_use = false;  // claimed by a worker right now
  // Recently decoded metas: chunked callers overlap requests by the
  // temporal-stack depth (and B-reorder) — serving those few frames
  // from cache avoids restarting the whole GoP prefix.
  std::deque<std::pair<uint32_t, FrameMeta>> recent;
};

constexpr size_t kRecentCap = 16;

struct DemuxHandle {
  Mp4File file;
  std::map<uint32_t, GopDecoderState> gop_decs;  // key: gop first_sample
  std::mutex mu;
};

// Keep at most this many per-GoP decoder states cached (each holds an
// MB context array + DPB mv fields, ~2 MB at 720p).
constexpr size_t kGopCacheCap = 64;

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// MP4 demuxer
// ---------------------------------------------------------------------------

void* cova_mp4_open(const char* path) {
  auto* h = new DemuxHandle();
  if (!h->file.open(path)) {
    delete h;
    return nullptr;
  }
  return h;
}

void cova_mp4_close(void* h) { delete (DemuxHandle*)h; }

int cova_mp4_num_samples(void* h) {
  return (int)((DemuxHandle*)h)->file.track().samples.size();
}

int cova_mp4_num_gops(void* h) { return (int)((DemuxHandle*)h)->file.gops().size(); }

void cova_mp4_gop_info(void* h, int g, uint32_t* first, uint32_t* count) {
  const auto& gops = ((DemuxHandle*)h)->file.gops();
  *first = gops[g].first_sample;
  *count = gops[g].num_samples;
}

void cova_mp4_track_info(void* h, int* width, int* height, uint32_t* timescale,
                         int* nal_length_size) {
  const Mp4Track& t = ((DemuxHandle*)h)->file.track();
  *width = t.width;
  *height = t.height;
  *timescale = t.timescale;
  *nal_length_size = t.nal_length_size;
}

void cova_mp4_sample_info(void* h, int idx, uint32_t* size, int64_t* dts,
                          int64_t* pts, int* keyframe) {
  const Mp4Sample& s = ((DemuxHandle*)h)->file.track().samples[idx];
  *size = s.size;
  *dts = s.dts;
  *pts = s.pts;
  *keyframe = s.keyframe ? 1 : 0;
}

int cova_mp4_read_sample(void* h, int idx, uint8_t* buf, int cap) {
  std::vector<uint8_t> tmp;
  if (!((DemuxHandle*)h)->file.read_sample(idx, &tmp)) return -1;
  if ((int)tmp.size() > cap) return -1;
  memcpy(buf, tmp.data(), tmp.size());
  return (int)tmp.size();
}

// Rebuild an avcC extradata blob from the stored parameter sets.
int cova_mp4_extradata(void* h, uint8_t* buf, int cap) {
  const Mp4Track& t = ((DemuxHandle*)h)->file.track();
  std::vector<uint8_t> out;
  if (t.sps.empty()) return -1;
  const auto& sps = t.sps[0];
  out.push_back(1);
  out.push_back(sps.size() > 1 ? sps[1] : 0);
  out.push_back(sps.size() > 2 ? sps[2] : 0);
  out.push_back(sps.size() > 3 ? sps[3] : 0);
  out.push_back(0xfc | (t.nal_length_size - 1));
  out.push_back(0xe0 | (uint8_t)t.sps.size());
  for (const auto& s : t.sps) {
    out.push_back((uint8_t)(s.size() >> 8));
    out.push_back((uint8_t)s.size());
    out.insert(out.end(), s.begin(), s.end());
  }
  out.push_back((uint8_t)t.pps.size());
  for (const auto& p : t.pps) {
    out.push_back((uint8_t)(p.size() >> 8));
    out.push_back((uint8_t)p.size());
    out.insert(out.end(), p.begin(), p.end());
  }
  if ((int)out.size() > cap) return -1;
  memcpy(buf, out.data(), out.size());
  return (int)out.size();
}

// The CODED macroblock grid from the track's SPS. This differs from
// ceil(display/16) whenever the coded size is cropped — e.g. MBAFF
// frames round the coded height to a multiple of 32 (a 1280x720 MBAFF
// encode codes 46 MB rows and crops 16 px), and the entropy-decode
// batch APIs match buffers against the CODED grid. Returns 0 on
// success.
int cova_mp4_mb_grid(void* h, int* mb_w, int* mb_h) {
  const Mp4Track& t = ((DemuxHandle*)h)->file.track();
  if (t.sps.empty() || t.sps[0].size() < 2) return -1;
  std::vector<uint8_t> rbsp =
      ebsp_to_rbsp(t.sps[0].data() + 1, t.sps[0].size() - 1);
  Sps sps;
  if (!parse_sps(rbsp.data(), rbsp.size(), &sps)) return -1;
  *mb_w = sps.width_mbs();
  *mb_h = sps.height_mbs();
  return 0;
}

// Field parity of a sample's first coded slice: 0 = frame picture,
// 1 = top field, 2 = bottom field, -1 on parse failure. PAFF streams
// carry one FIELD per sample; the pipeline's selective pixel decode
// pairs complementary fields into one decode unit (libavcodec weaves
// two fields into one output frame carrying the FIRST field's pts).
int cova_mp4_field_parity(void* h, int idx) {
  auto* H = (DemuxHandle*)h;
  const Mp4Track& t = H->file.track();
  if (idx < 0 || (size_t)idx >= t.samples.size()) return -1;
  // Fast path: frame_mbs_only streams cannot carry field pictures.
  std::map<int, Sps> spss;
  bool any_interlaced = false;
  for (const auto& s : t.sps) {
    if (s.size() < 2) continue;
    std::vector<uint8_t> rbsp = ebsp_to_rbsp(s.data() + 1, s.size() - 1);
    Sps v;
    if (parse_sps(rbsp.data(), rbsp.size(), &v)) {
      any_interlaced |= !v.frame_mbs_only;
      spss[v.sps_id] = v;
    }
  }
  if (!any_interlaced) return 0;
  std::map<int, Pps> ppss;
  for (const auto& p : t.pps) {
    if (p.size() < 2) continue;
    std::vector<uint8_t> rbsp = ebsp_to_rbsp(p.data() + 1, p.size() - 1);
    Pps v;
    if (parse_pps(rbsp.data(), rbsp.size(), spss, &v)) ppss[v.pps_id] = v;
  }
  std::vector<uint8_t> au;
  if (!H->file.read_sample(idx, &au)) return -1;
  size_t pos = 0, nsz = (size_t)t.nal_length_size;
  while (pos + nsz <= au.size()) {
    size_t len = 0;
    for (size_t i = 0; i < nsz; i++) len = (len << 8) | au[pos + i];
    pos += nsz;
    if (len == 0 || pos + len > au.size()) return -1;
    int nal_type = au[pos] & 0x1f;
    int nal_ref_idc = (au[pos] >> 5) & 3;
    if (nal_type == 1 || nal_type == 5) {
      std::vector<uint8_t> rbsp = ebsp_to_rbsp(au.data() + pos + 1, len - 1);
      BitReader br(rbsp.data(), rbsp.size());
      const Sps* sps = nullptr;
      const Pps* pps = nullptr;
      SliceHeader sh;
      if (!parse_slice_header(br, nal_type, nal_ref_idc, spss, ppss, &sps,
                              &pps, &sh))
        return -1;
      return sh.field_pic ? (sh.bottom_field ? 2 : 1) : 0;
    }
    pos += len;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// Batch entropy decode
// ---------------------------------------------------------------------------

}  // extern "C"

namespace {

// Shared engine: decode the requested samples GoP-by-GoP (units run in
// parallel across GoPs; strictly sequential inside each, reusing the
// handle's cached per-GoP decoder so consecutive chunked calls resume
// instead of re-decoding). emit_live(slot, dec) for each freshly
// decoded request (the decoder holds the picture; callers export in
// whatever layout they need without a FrameMeta round-trip),
// emit_cached(slot, meta) for requests served from the recent-meta
// cache, err(slot) for invalid/failed ones.
// Optional pre-decode hook: called with (slot, decoder) right before a
// requested sample is decoded — the packed16 path uses it to arm the
// decoder's inline wire16 sink so the export happens at MB-decode time
// (MbCtx hot in L1) instead of as a cold post-hoc array walk.
inline void no_pre_decode(int, EntropyDecoder&) {}

template <typename EmitLiveFn, typename EmitCachedFn, typename ErrFn,
          typename PreFn = decltype(&no_pre_decode)>
void decode_batch_gops(DemuxHandle* H, const int32_t* indices, int count,
                       int threads, int mb_w, int mb_h, EmitLiveFn emit_live,
                       EmitCachedFn emit_cached, ErrFn err,
                       PreFn pre_decode = &no_pre_decode) {
  const Mp4Track& track = H->file.track();
  const auto& gops = H->file.gops();
  if (threads < 1) threads = 1;

  struct Unit {
    uint32_t gop_first, gop_end;
    std::vector<std::pair<int, uint32_t>> out;  // (slot, sample)
  };
  std::map<uint32_t, Unit> units_by_gop;
  for (int i = 0; i < count; i++) {
    int32_t s = indices[i];
    if (s < 0 || s >= (int32_t)track.samples.size()) {
      err(i);
      continue;
    }
    // gops sorted by first_sample: find the one containing s.
    size_t lo = 0, hi = gops.size();
    while (lo + 1 < hi) {
      size_t mid = (lo + hi) / 2;
      if (gops[mid].first_sample <= (uint32_t)s)
        lo = mid;
      else
        hi = mid;
    }
    const Gop& g = gops[lo];
    Unit& u = units_by_gop[g.first_sample];
    u.gop_first = g.first_sample;
    u.gop_end = g.first_sample + g.num_samples;
    u.out.emplace_back(i, (uint32_t)s);
  }
  std::vector<Unit> units;
  for (auto& kv : units_by_gop) units.push_back(std::move(kv.second));

  std::atomic<size_t> next_unit(0);
  auto worker = [&]() {
    std::vector<uint8_t> au;
    while (true) {
      size_t ui = next_unit.fetch_add(1);
      if (ui >= units.size()) break;
      Unit& u = units[ui];
      std::sort(u.out.begin(), u.out.end(),
                [](const auto& a, const auto& b) { return a.second < b.second; });

      GopDecoderState* gd;
      {
        std::lock_guard<std::mutex> lk(H->mu);
        gd = &H->gop_decs[u.gop_first];
        gd->in_use = true;
        if (!gd->dec) {
          gd->dec.reset(new EntropyDecoder(track.nal_length_size));
          gd->dec->export_sums = false;  // validation-only fields
          for (const auto& s : track.sps)
            gd->dec->add_parameter_set(s.data(), s.size());
          for (const auto& p : track.pps)
            gd->dec->add_parameter_set(p.data(), p.size());
          gd->next = u.gop_first;
        }
      }
      // Requests below `next` are served from the recent-meta cache;
      // a miss there forces a GoP restart from the IDR.
      auto cached = [&](uint32_t s) -> const FrameMeta* {
        for (const auto& kv : gd->recent)
          if (kv.first == s) return &kv.second;
        return nullptr;
      };
      bool rewind = false;
      for (const auto& [slot, s] : u.out)
        if (s < gd->next && !cached(s)) {
          rewind = true;
          break;
        }
      if (rewind) {
        gd->dec.reset(new EntropyDecoder(track.nal_length_size));
        gd->dec->export_sums = false;
        for (const auto& s : track.sps)
          gd->dec->add_parameter_set(s.data(), s.size());
        for (const auto& p : track.pps)
          gd->dec->add_parameter_set(p.data(), p.size());
        gd->next = u.gop_first;
        gd->recent.clear();
      }
      uint32_t hi_sample = u.out.back().second;
      size_t oi = 0;
      while (oi < u.out.size() && u.out[oi].second < gd->next) {
        const FrameMeta* m = cached(u.out[oi].second);
        if (m)
          emit_cached(u.out[oi].first, *m);
        else
          err(u.out[oi].first);  // unreachable after the rewind check
        oi++;
      }
      for (uint32_t s = gd->next; s <= hi_sample; s++) {
        // Arm the inline sink only for decodes a request is waiting on;
        // dependency-only frames must not write into any slot buffer.
        if (oi < u.out.size() && u.out[oi].second == s)
          pre_decode(u.out[oi].first, *gd->dec);
        else
          gd->dec->clear_wire_sink();
        bool ok = H->file.read_sample(s, &au) &&
                  gd->dec->decode_au_header(au.data(), au.size()) == 0 &&
                  gd->dec->mb_width() == mb_w && gd->dec->mb_height() == mb_h;
        while (oi < u.out.size() && u.out[oi].second == s) {
          if (ok)
            emit_live(u.out[oi].first, *gd->dec);
          else
            err(u.out[oi].first);
          oi++;
        }
        // Cache only the request's tail: later chunks can re-request
        // only frames near the current frontier, and caching every
        // frame would export+copy a ~58 KB meta once per frame.
        if (ok && s + kRecentCap > hi_sample) {
          FrameMeta meta;
          gd->dec->export_meta(&meta);
          gd->recent.emplace_back(s, std::move(meta));
          if (gd->recent.size() > kRecentCap) gd->recent.pop_front();
        }
      }
      gd->next = std::max(gd->next, hi_sample + 1);
      // The decoder may be cached across API calls: never let it keep a
      // sink pointer into this call's output buffer.
      gd->dec->clear_wire_sink();
      {
        std::lock_guard<std::mutex> lk(H->mu);
        gd->in_use = false;
        if (gd->next >= u.gop_end) {
          H->gop_decs.erase(u.gop_first);  // GoP exhausted
        } else if (H->gop_decs.size() > kGopCacheCap) {
          for (auto it = H->gop_decs.begin(); it != H->gop_decs.end();) {
            if (!it->second.in_use && H->gop_decs.size() > kGopCacheCap)
              it = H->gop_decs.erase(it);
            else
              ++it;
          }
        }
      }
    }
  };
  std::vector<std::thread> pool;
  int nthreads = std::min<size_t>(threads, units.size() ? units.size() : 1);
  for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Decode an explicit sample-index list with `threads` workers (e.g. a
// contiguous decode range in display order). Outputs as in
// cova_entdec_decode_range.
int cova_entdec_decode_indices(void* h, const int32_t* indices, int count,
                               int threads, int mb_w, int mb_h,
                               uint8_t* mb_class, int16_t* mv_x, int16_t* mv_y,
                               uint16_t* nnz, uint8_t* slice_types,
                               int16_t* mv_sx, int16_t* mv_sy) {
  auto* H = (DemuxHandle*)h;
  size_t grid = (size_t)mb_w * mb_h;
  auto copy_out = [&](int i, const FrameMeta& meta) {
    slice_types[i] = (uint8_t)meta.slice_type;
    memcpy(mb_class + (size_t)i * grid, meta.mb_class.data(), grid);
    memcpy(mv_x + (size_t)i * grid, meta.mv_x.data(),
           grid * sizeof(int16_t));
    memcpy(mv_y + (size_t)i * grid, meta.mv_y.data(),
           grid * sizeof(int16_t));
    memcpy(nnz + (size_t)i * grid, meta.nnz.data(),
           grid * sizeof(uint16_t));
    if (mv_sx)
      memcpy(mv_sx + (size_t)i * grid, meta.mv_sx.data(),
             grid * sizeof(int16_t));
    if (mv_sy)
      memcpy(mv_sy + (size_t)i * grid, meta.mv_sy.data(),
             grid * sizeof(int16_t));
  };
  decode_batch_gops(
      H, indices, count, threads, mb_w, mb_h,
      [&](int i, const EntropyDecoder& dec) {
        // Scratch FrameMeta per worker thread (vector capacity reused).
        thread_local FrameMeta meta;
        dec.export_meta(&meta);
        copy_out(i, meta);
      },
      [&](int i, const FrameMeta& meta) { copy_out(i, meta); },
      [&](int i) {
        slice_types[i] = 255;
        memset(mb_class + (size_t)i * grid, MB_UNKNOWN, grid);
        memset(mv_x + (size_t)i * grid, 0, grid * sizeof(int16_t));
        memset(mv_y + (size_t)i * grid, 0, grid * sizeof(int16_t));
        memset(nnz + (size_t)i * grid, 0, grid * sizeof(uint16_t));
        if (mv_sx) memset(mv_sx + (size_t)i * grid, 0, grid * sizeof(int16_t));
        if (mv_sy) memset(mv_sy + (size_t)i * grid, 0, grid * sizeof(int16_t));
      });
  return 0;
}

// Decode an explicit sample-index list directly into the packed u8
// BlobNet input layout [mb_class, |mv_x|/4, |mv_y|/4(, nnz/4)] — the
// pack_metadata transform (cova_tpu/utils/dataset.py:54-69) fused into
// the decode workers, saving a python-side int16->u8 pass per chunk on
// the pipeline's hot path. `out` is count*mb_h*mb_w*channels bytes.
int cova_entdec_decode_indices_packed(void* h, const int32_t* indices,
                                      int count, int threads, int mb_w,
                                      int mb_h, int channels, uint8_t* out,
                                      uint8_t* slice_types, int signed_mv) {
  if (channels != 3 && channels != 4) return -2;
  auto* H = (DemuxHandle*)h;
  size_t grid = (size_t)mb_w * mb_h;
  decode_batch_gops(
      H, indices, count, threads, mb_w, mb_h,
      [&](int i, const EntropyDecoder& dec) {
        // Fused export straight from the MB contexts — no FrameMeta
        // round-trip on the pipeline's hot path (~7% of a decode).
        slice_types[i] = (uint8_t)dec.last_slice_type();
        dec.export_packed(out + (size_t)i * grid * channels, channels,
                          signed_mv != 0);
      },
      [&](int i, const FrameMeta& meta) {
        uint8_t* dst = out + (size_t)i * grid * channels;
        slice_types[i] = (uint8_t)meta.slice_type;
        for (size_t k = 0; k < grid; k++) {
          uint8_t* p8 = dst + k * channels;
          p8[0] = meta.mb_class[k];
          if (signed_mv) {
            // mean signed mv, full-pel, offset-128 (the reference feeds
            // signed per-MB mv, utils/data/parse.py:5-31; consumers
            // normalize with clip(x-128,-6,6)/6).
            int mx = 128 + (meta.mv_sx[k] >> 2);
            int my = 128 + (meta.mv_sy[k] >> 2);
            p8[1] = (uint8_t)(mx < 0 ? 0 : mx > 255 ? 255 : mx);
            p8[2] = (uint8_t)(my < 0 ? 0 : my > 255 ? 255 : my);
          } else {
            // mean |mv| per MB, quarter-pel -> full-pel, saturated u8.
            int mx = meta.mv_x[k] >> 2;
            int my = meta.mv_y[k] >> 2;
            p8[1] = (uint8_t)(mx > 255 ? 255 : mx);
            p8[2] = (uint8_t)(my > 255 ? 255 : my);
          }
          if (channels == 4) {
            int nz = meta.nnz[k] >> 2;
            p8[3] = (uint8_t)(nz > 255 ? 255 : nz);
          }
        }
      },
      [&](int i) {
        uint8_t* dst = out + (size_t)i * grid * channels;
        slice_types[i] = 255;
        memset(dst, 0, grid * channels);
        for (size_t k = 0; k < grid; k++) {
          dst[k * channels] = MB_UNKNOWN;
          if (signed_mv) {
            dst[k * channels + 1] = 128;  // offset-128 zero motion
            dst[k * channels + 2] = 128;
          }
        }
      });
  return 0;
}

// Like cova_entdec_decode_indices_packed but emitting the 2-byte/cell
// wire format (entdec.h export_packed16): out is count*mb_h*mb_w*2
// bytes. Fields saturate exactly at BlobNet's clip ranges, so the
// device-side unpack reproduces the 3/4-channel u8 input bit-for-bit
// while halving the host->device chunk upload.
int cova_entdec_decode_indices_packed16(void* h, const int32_t* indices,
                                        int count, int threads, int mb_w,
                                        int mb_h, int with_nnz, int signed_mv,
                                        uint8_t* out, uint8_t* slice_types) {
  auto* H = (DemuxHandle*)h;
  size_t grid = (size_t)mb_w * mb_h;
  decode_batch_gops(
      H, indices, count, threads, mb_w, mb_h,
      [&](int i, const EntropyDecoder& dec) {
        slice_types[i] = (uint8_t)dec.last_slice_type();
        // The pre_decode hook below armed the inline sink for the first
        // slot waiting on each sample — its export already happened at
        // MB-decode time. Duplicate slots for the same sample (and any
        // decode where the sink could not activate) fall back to the
        // post-hoc walk; both produce identical bytes (wire_cell).
        uint8_t* dst = out + (size_t)i * grid * 2;
        if (!dec.wire_complete(dst))
          dec.export_packed16(dst, with_nnz != 0, signed_mv != 0);
      },
      [&](int i, const FrameMeta& meta) {
        // Cache-hit repack from FrameMeta — same saturation math as
        // export_packed16.
        uint8_t* dst = out + (size_t)i * grid * 2;
        slice_types[i] = (uint8_t)meta.slice_type;
        for (size_t k = 0; k < grid; k++) {
          int mvx, mvy;
          if (signed_mv) {
            int fx = (int)meta.mv_sx[k] >> 2;
            int fy = (int)meta.mv_sy[k] >> 2;
            mvx = (fx < -8 ? -8 : fx > 7 ? 7 : fx) + 8;
            mvy = (fy < -8 ? -8 : fy > 7 ? 7 : fy) + 8;
          } else {
            int fx = (int)meta.mv_x[k] >> 2;
            int fy = (int)meta.mv_y[k] >> 2;
            mvx = fx > 15 ? 15 : fx;
            mvy = fy > 15 ? 15 : fy;
          }
          int nz = 0;
          if (with_nnz) {
            nz = meta.nnz[k] >> 2;
            if (nz > 7) nz = 7;
          }
          dst[k * 2] = (uint8_t)((meta.mb_class[k] & 7) | (nz << 3));
          dst[k * 2 + 1] = (uint8_t)(mvx | (mvy << 4));
        }
      },
      [&](int i) {
        uint8_t* dst = out + (size_t)i * grid * 2;
        slice_types[i] = 255;
        uint8_t b1 = signed_mv ? 0x88 : 0;
        for (size_t k = 0; k < grid; k++) {
          dst[k * 2] = MB_UNKNOWN;
          dst[k * 2 + 1] = b1;
        }
      },
      [&](int i, EntropyDecoder& dec) {
        dec.set_wire_sink(out + (size_t)i * grid * 2, mb_w, mb_h,
                          with_nnz != 0, signed_mv != 0);
      });
  return 0;
}

// Decode samples [start, start+count) of the file with `threads` workers.
// Outputs are per-frame macroblock grids, flattened frame-major:
//   mb_class/mv_x/mv_y/nnz: count * mb_w * mb_h entries
//   slice_types: count entries (0 P, 1 B, 2 I, 255 = error)
// Returns 0 on success (individual frame errors flagged in slice_types).
int cova_entdec_decode_range(void* h, int start, int count, int threads,
                             int mb_w, int mb_h, uint8_t* mb_class,
                             int16_t* mv_x, int16_t* mv_y, uint16_t* nnz,
                             uint8_t* slice_types) {
  std::vector<int32_t> idx(count > 0 ? count : 0);
  for (int i = 0; i < count; i++) idx[i] = start + i;
  return cova_entdec_decode_indices(h, idx.data(), count, threads, mb_w, mb_h,
                                    mb_class, mv_x, mv_y, nnz, slice_types,
                                    nullptr, nullptr);
}

}  // extern "C"
