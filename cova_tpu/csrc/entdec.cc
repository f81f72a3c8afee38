#include "entdec.h"

#include "cavlc_tables.h"
#include "cavlc_vlc.h"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace cova {

// COVA_ENTDEC_TRACE=1: per-MB parse trace; =2: additionally per-bin.
// Resolved once at .so load (every user sets it before process spawn):
// the per-MB hot paths then pay one predicted-never-taken load+branch
// instead of a function call (gprof showed the callable variant at
// ~23M calls / ~2% of a decode pass).
static const int g_trace_level = [] {
  const char* e = getenv("COVA_ENTDEC_TRACE");
  return e ? atoi(e) : 0;
}();
static inline int trace_level() { return g_trace_level; }
static inline bool trace_enabled() { return g_trace_level >= 1; }
static void trace_bin(int ctx, int bin) {
  fprintf(stderr, "D ctx=%d bin=%d\n", ctx, bin);
}

namespace {

// 4x4 luma block coding order (8x8 Z order, 4x4 Z within) -> MB raster.
inline int blk_raster(int i8, int i4) {
  int x4 = 2 * (i8 & 1) + (i4 & 1);
  int y4 = 2 * (i8 >> 1) + (i4 >> 1);
  return y4 * 4 + x4;
}

// Residual context bases per ctxBlockCat (spec Table 9-40, incl. the
// High 4:4:4 categories): 0-4 luma, 5 luma 8x8, 6-9 Cb
// (I16DC/I16AC/4x4/8x8), 10-13 Cr. Values match libavcodec's
// h264_cabac.c offset tables (same normative assignment).
const int kCbfBase[14] = {85,  89,  93,  97,   101,  1012, 460,
                          464, 468, 1016, 472, 476,  480,  1020};
const int kSigBase[14] = {105,      105 + 15, 105 + 29, 105 + 44, 105 + 47,
                          402,      484,      484 + 15, 484 + 29, 660,
                          528,      528 + 15, 528 + 29, 718};
const int kLastBase[14] = {166,      166 + 15, 166 + 29, 166 + 44, 166 + 47,
                           417,      572,      572 + 15, 572 + 29, 690,
                           616,      616 + 15, 616 + 29, 748};
const int kAbsBase[14] = {227,      227 + 10, 227 + 20, 227 + 30, 227 + 39,
                          426,      952,      952 + 10, 952 + 20, 708,
                          982,      982 + 10, 982 + 20, 766};

struct PartSpec {  // partition geometry in 4x4 cell units within the MB
  int x0, y0, w, h;
};

// C-style truncating (toward-zero) division by 2^k — matches `v / (1<<k)`
// for negative v, unlike an arithmetic shift.
inline int div_trunc_pow2(int v, int k) {
  return v >= 0 ? v >> k : -((-v) >> k);
}

}  // namespace

bool EntropyDecoder::add_parameter_set(const uint8_t* nal, size_t size) {
  if (size < 1) return false;
  int type = nal[0] & 0x1f;
  std::vector<uint8_t> rbsp = ebsp_to_rbsp(nal + 1, size - 1);
  if (type == NAL_SPS) {
    Sps sps;
    if (!parse_sps(rbsp.data(), rbsp.size(), &sps)) return false;
    spss_[sps.sps_id] = sps;
    return true;
  }
  if (type == NAL_PPS) {
    Pps pps;
    if (!parse_pps(rbsp.data(), rbsp.size(), spss_, &pps)) return false;
    ppss_[pps.pps_id] = pps;
    return true;
  }
  return false;
}

void EntropyDecoder::start_picture(const Sps& sps) {
  mb_w_ = sps.width_mbs();
  mb_h_ = sps.height_mbs();
  // A PAFF field picture parses mb_h_/2 MB rows (field raster, stored
  // in the leading rows of the frame-sized mbs_ array); the generation
  // stamp keeps the unused tail rows invisible to avail().
  pic_mb_rows_ = field_pic_ ? mb_h_ / 2 : mb_h_;
  // New picture = new generation; stale entries are filtered by the
  // MbCtx::gen check in avail(), so no per-picture array reset is
  // needed. A full reset happens only on size change or gen wrap.
  gen_++;
  // separate_colour_plane streams code each plane as an independent
  // monochrome picture: three plane-sized MB regions so neighbor
  // derivations never cross planes (exports read plane 0 = luma).
  size_t need =
      (size_t)mb_w_ * mb_h_ * (sps.separate_colour_plane ? 3 : 1);
  if (mbs_.size() != need || gen_ == 0) {
    mbs_.assign(need, MbCtx());
    if (gen_ == 0) gen_ = 1;
  }
  // Arm the inline wire16 sink for this picture only if its dimensions
  // match the sink buffer; prefill the "unknown" pattern so cells not
  // covered by any slice export exactly as a post-hoc export_packed16
  // would (gen-mismatch path there).
  // The inline sink indexes cells by (ctx - mbs_.data()), which is the
  // raster cell only for progressive pictures; MBAFF exports go through
  // the post-hoc export_* with the src_index() remap instead.
  wire_active_ = wire_dst_ && !mbaff_ && !field_pic_ &&
                 mb_w_ == wire_mb_w_ && mb_h_ == wire_mb_h_;
  snap_armed_ = false;  // re-armed after compute_poc when a ref picture
  if (wire_active_) {
    const uint8_t b[2] = {MB_UNKNOWN, (uint8_t)(wire_signed_ ? 0x88 : 0)};
    size_t n = (size_t)mb_w_ * mb_h_;
    for (size_t i = 0; i < n; i++) memcpy(wire_dst_ + 2 * i, b, 2);
  }
  picture_started_ = true;
}

int EntropyDecoder::decode_au(const uint8_t* data, size_t size,
                              FrameMeta* out) {
  int rc = decode_au_header(data, size);
  if (rc != 0) return rc;
  if (out) export_meta(out);
  return 0;
}

int EntropyDecoder::decode_au_header(const uint8_t* data, size_t size) {
  picture_started_ = false;
  wire_done_ = false;
  slice_id_ = 0;
  slice_list_pocs_.clear();
  int first_slice_type = -1;
  bool keyframe = false;

  size_t pos = 0;
  while (pos < size) {
    const uint8_t* nal = nullptr;
    size_t nal_size = 0;
    if (nal_length_size_ > 0) {
      if (pos + nal_length_size_ > size) break;
      uint64_t len = 0;
      for (int i = 0; i < nal_length_size_; i++) len = (len << 8) | data[pos + i];
      pos += nal_length_size_;
      if (pos + len > size) break;
      nal = data + pos;
      nal_size = len;
      pos += len;
    } else {
      // Annex-B: find start code
      while (pos + 3 < size &&
             !(data[pos] == 0 && data[pos + 1] == 0 && data[pos + 2] == 1))
        pos++;
      if (pos + 3 >= size) break;
      pos += 3;
      size_t start = pos;
      while (pos + 3 < size &&
             !(data[pos] == 0 && data[pos + 1] == 0 && data[pos + 2] == 1))
        pos++;
      size_t end = (pos + 3 < size) ? pos : size;
      while (end > start && data[end - 1] == 0) end--;  // trailing zeros
      nal = data + start;
      nal_size = end - start;
    }
    if (nal_size < 1) continue;
    int nal_type = nal[0] & 0x1f;
    int nal_ref_idc = (nal[0] >> 5) & 3;
    if (nal_type == NAL_SPS || nal_type == NAL_PPS) {
      add_parameter_set(nal, nal_size);
    } else if (nal_type == NAL_SLICE_NON_IDR || nal_type == NAL_SLICE_IDR) {
      ebsp_to_rbsp_into(nal + 1, nal_size - 1, &rbsp_scratch_);
      int rc = decode_slice(rbsp_scratch_.data(), rbsp_scratch_.size(),
                            nal_type, nal_ref_idc);
      if (rc != 0) return rc;
      if (first_slice_type < 0) first_slice_type = sh_.type;
      if (nal_type == NAL_SLICE_IDR) keyframe = true;
      slice_id_++;
    }
    // SEI / AUD / filler ignored.
  }

  if (!picture_started_) return -1;
  store_ref_picture();
  first_slice_type_ = first_slice_type;
  last_keyframe_ = keyframe;
  wire_done_ = wire_active_;
  return 0;
}

void EntropyDecoder::export_meta(FrameMeta* out) const {
  out->mb_width = mb_w_;
  out->mb_height = mb_h_;
  out->slice_type = first_slice_type_;
  out->keyframe = last_keyframe_;
  size_t n = (size_t)mb_w_ * mb_h_;
  out->mb_class.resize(n);
  out->mv_x.resize(n);
  out->mv_y.resize(n);
  out->mv_sx.resize(n);
  out->mv_sy.resize(n);
  out->nnz.resize(n);
  out->mv_sum_x.resize(export_sums ? n : 0);
  out->mv_sum_y.resize(export_sums ? n : 0);
  out->mv_cells.resize(export_sums ? n : 0);
  out->mb_field.assign(n, 0);
  for (size_t i = 0; i < n; i++) {
    const MbCtx& m = mbs_[src_index(i)];
    bool decoded = m.gen == gen_ && m.decoded;
    if (!decoded) {
      out->mb_class[i] = MB_UNKNOWN;
      out->mv_x[i] = 0;
      out->mv_y[i] = 0;
      out->mv_sx[i] = 0;
      out->mv_sy[i] = 0;
      out->nnz[i] = 0;
      if (export_sums) {
        out->mv_sum_x[i] = 0;
        out->mv_sum_y[i] = 0;
        out->mv_cells[i] = 0;
      }
      continue;
    }
    out->mb_class[i] = m.mb_class;
    if (mbaff_) out->mb_field[i] = m.field_flag;
    else if (field_pic_) out->mb_field[i] = 1;  // PAFF: every MB a field MB
    int sx = m.mv_sum[0], sy = m.mv_sum[1], cnt = m.mv_cells;
    // cnt is 16 (one list) or 32 (both lists) for almost every decoded
    // MB; truncating shift-division avoids 4 idiv stalls per MB on the
    // hot export loop (mv_sum is non-negative; ssum needs the
    // toward-zero fixup).
    if (cnt == 16) {
      out->mv_x[i] = (int16_t)(sx >> 4);
      out->mv_y[i] = (int16_t)(sy >> 4);
      out->mv_sx[i] = (int16_t)div_trunc_pow2(m.mv_ssum[0], 4);
      out->mv_sy[i] = (int16_t)div_trunc_pow2(m.mv_ssum[1], 4);
    } else if (cnt == 32) {
      out->mv_x[i] = (int16_t)(sx >> 5);
      out->mv_y[i] = (int16_t)(sy >> 5);
      out->mv_sx[i] = (int16_t)div_trunc_pow2(m.mv_ssum[0], 5);
      out->mv_sy[i] = (int16_t)div_trunc_pow2(m.mv_ssum[1], 5);
    } else {
      out->mv_x[i] = cnt ? (int16_t)(sx / cnt) : 0;
      out->mv_y[i] = cnt ? (int16_t)(sy / cnt) : 0;
      out->mv_sx[i] = cnt ? (int16_t)(m.mv_ssum[0] / cnt) : 0;
      out->mv_sy[i] = cnt ? (int16_t)(m.mv_ssum[1] / cnt) : 0;
    }
    out->nnz[i] = m.nnz_total;
    if (export_sums) {
      out->mv_sum_x[i] = sx;
      out->mv_sum_y[i] = sy;
      out->mv_cells[i] = (uint8_t)cnt;
    }
  }
}

void EntropyDecoder::export_packed(uint8_t* dst, int channels,
                                   bool signed_mv) const {
  size_t n = (size_t)mb_w_ * mb_h_;
  for (size_t i = 0; i < n; i++) {
    const MbCtx& m = mbs_[src_index(i)];
    uint8_t* p8 = dst + i * channels;
    if (!(m.gen == gen_ && m.decoded)) {
      p8[0] = MB_UNKNOWN;
      p8[1] = p8[2] = signed_mv ? 128 : 0;
      if (channels == 4) p8[3] = 0;
      continue;
    }
    p8[0] = m.mb_class;
    int cnt = m.mv_cells;
    if (signed_mv) {
      // Mean signed mv (toward-zero int16 mean, as export_meta), then
      // full-pel via arithmetic >>2, offset-128, clipped — identical
      // to the former FrameMeta+repack pipeline byte for byte.
      int msx = 0, msy = 0;
      if (cnt == 16) {
        msx = div_trunc_pow2(m.mv_ssum[0], 4);
        msy = div_trunc_pow2(m.mv_ssum[1], 4);
      } else if (cnt == 32) {
        msx = div_trunc_pow2(m.mv_ssum[0], 5);
        msy = div_trunc_pow2(m.mv_ssum[1], 5);
      } else if (cnt) {
        msx = m.mv_ssum[0] / cnt;
        msy = m.mv_ssum[1] / cnt;
      }
      int mx = 128 + ((int)(int16_t)msx >> 2);
      int my = 128 + ((int)(int16_t)msy >> 2);
      p8[1] = (uint8_t)(mx < 0 ? 0 : mx > 255 ? 255 : mx);
      p8[2] = (uint8_t)(my < 0 ? 0 : my > 255 ? 255 : my);
    } else {
      int ax = 0, ay = 0;
      if (cnt == 16) {
        ax = m.mv_sum[0] >> 4;
        ay = m.mv_sum[1] >> 4;
      } else if (cnt == 32) {
        ax = m.mv_sum[0] >> 5;
        ay = m.mv_sum[1] >> 5;
      } else if (cnt) {
        ax = m.mv_sum[0] / cnt;
        ay = m.mv_sum[1] / cnt;
      }
      int mx = (int)(int16_t)ax >> 2;
      int my = (int)(int16_t)ay >> 2;
      p8[1] = (uint8_t)(mx > 255 ? 255 : mx);
      p8[2] = (uint8_t)(my > 255 ? 255 : my);
    }
    if (channels == 4) {
      int nz = m.nnz_total >> 2;
      p8[3] = (uint8_t)(nz > 255 ? 255 : nz);
    }
  }
}

void EntropyDecoder::export_packed16(uint8_t* dst, bool with_nnz,
                                     bool signed_mv) const {
  // 2-byte/cell wire format for the host->device link (half the bytes
  // of the u8 channel layout): byte0 = mb_class(3b) | nnz(3b),
  // byte1 = mv_x(4b) | mv_y(4b). Each field saturates exactly where
  // BlobNet's clip(0,6) / clip(-6,6) preprocessing makes wider values
  // indistinguishable, so the unpacked model input is bit-identical to
  // the 3/4-channel u8 layout (pinned by tests/test_pipeline.py).
  size_t n = (size_t)mb_w_ * mb_h_;
  for (size_t i = 0; i < n; i++) {
    const MbCtx& m = mbs_[src_index(i)];
    uint8_t* p8 = dst + i * 2;
    if (!(m.gen == gen_ && m.decoded)) {
      p8[0] = MB_UNKNOWN;  // mb_class 6, nnz 0
      p8[1] = signed_mv ? 0x88 : 0;  // zero motion
      continue;
    }
    wire_cell(m, p8, with_nnz, signed_mv);
  }
}

void EntropyDecoder::wire_cell(const MbCtx& m, uint8_t* p8, bool with_nnz,
                               bool signed_mv) const {
  int cnt = m.mv_cells;
  int mvx, mvy;
  if (signed_mv) {
    int msx = 0, msy = 0;
    if (cnt == 16) {
      msx = div_trunc_pow2(m.mv_ssum[0], 4);
      msy = div_trunc_pow2(m.mv_ssum[1], 4);
    } else if (cnt == 32) {
      msx = div_trunc_pow2(m.mv_ssum[0], 5);
      msy = div_trunc_pow2(m.mv_ssum[1], 5);
    } else if (cnt) {
      msx = m.mv_ssum[0] / cnt;
      msy = m.mv_ssum[1] / cnt;
    }
    int fx = (int)(int16_t)msx >> 2;  // full-pel signed
    int fy = (int)(int16_t)msy >> 2;
    mvx = (fx < -8 ? -8 : fx > 7 ? 7 : fx) + 8;
    mvy = (fy < -8 ? -8 : fy > 7 ? 7 : fy) + 8;
  } else {
    int ax = 0, ay = 0;
    if (cnt == 16) {
      ax = m.mv_sum[0] >> 4;
      ay = m.mv_sum[1] >> 4;
    } else if (cnt == 32) {
      ax = m.mv_sum[0] >> 5;
      ay = m.mv_sum[1] >> 5;
    } else if (cnt) {
      ax = m.mv_sum[0] / cnt;
      ay = m.mv_sum[1] / cnt;
    }
    int fx = (int)(int16_t)ax >> 2;
    int fy = (int)(int16_t)ay >> 2;
    mvx = fx > 15 ? 15 : fx;
    mvy = fy > 15 ? 15 : fy;
  }
  int nz = 0;
  if (with_nnz) {
    nz = m.nnz_total >> 2;
    if (nz > 7) nz = 7;
  }
  p8[0] = (uint8_t)((m.mb_class & 7) | (nz << 3));
  p8[1] = (uint8_t)(mvx | (mvy << 4));
}

// ---------------------------------------------------------------------------
// CABAC syntax elements
// ---------------------------------------------------------------------------

int EntropyDecoder::cabac_mb_skip(int mb_x, int mb_y, bool b_slice) {
  MbCtx* a = nba_;
  MbCtx* b = nbb_;
  int ctx = (a && !a->skip ? 1 : 0) + (b && !b->skip ? 1 : 0);
  return cabac_.decision((b_slice ? 24 : 11) + ctx);
}

// Returns intra mb_type code: 0 = I_NxN, 1..24 = I_16x16 variants, 25 = PCM.
// Context assignment (verified against libavcodec's
// decode_cabac_intra_mb_type disassembly + CABAC bin-trace oracle): in I
// slices the suffix bins use distinct contexts base+3..base+7
// (cbpL 6, cbpC 7/8, pred 9/10); as the intra suffix of P/B mb_type the
// pairs share contexts (cbpC both base+2, pred both base+3).
int EntropyDecoder::cabac_mb_type_i(int ctx_base, bool intra_slice, int mb_x,
                                    int mb_y) {
  int c_first, c_cbpl, c_cbpc0, c_cbpc1, c_pred0, c_pred1;
  if (intra_slice) {
    MbCtx* a = nba_;
    MbCtx* b = nbb_;
    int inc = (a && (a->i16 || a->pcm) ? 1 : 0) + (b && (b->i16 || b->pcm) ? 1 : 0);
    // I-slice: distinct contexts 6,(7,8),(9,10) — verified against
    // libavcodec's decode_cabac_intra_mb_type disassembly.
    c_first = ctx_base + inc;
    c_cbpl = ctx_base + 3;
    c_cbpc0 = ctx_base + 4;
    c_cbpc1 = ctx_base + 5;
    c_pred0 = ctx_base + 6;
    c_pred1 = ctx_base + 7;
  } else {
    c_first = ctx_base;
    c_cbpl = ctx_base + 1;
    c_cbpc0 = c_cbpc1 = ctx_base + 2;
    c_pred0 = c_pred1 = ctx_base + 3;
  }
  if (cabac_.decision(c_first) == 0) return 0;  // I_NxN
  if (cabac_.terminate()) return 25;            // I_PCM
  int t = 1;
  t += 12 * cabac_.decision(c_cbpl);  // cbp_luma != 0
  if (cabac_.decision(c_cbpc0))
    t += 4 + 4 * cabac_.decision(c_cbpc1);  // cbp_chroma
  t += 2 * cabac_.decision(c_pred0);
  t += cabac_.decision(c_pred1);  // pred mode
  return t;
}

// P mb_type: 0 P_L0_16x16, 1 P_L0_L0_16x8, 2 P_L0_L0_8x16, 3 P_8x8;
// 5 + i for intra code i.
int EntropyDecoder::cabac_mb_type_p() {
  if (cabac_.decision(14)) return 5 + cabac_mb_type_i(17, false, 0, 0);
  if (cabac_.decision(15)) {
    return cabac_.decision(17) ? 1 : 2;  // 16x8 : 8x16
  }
  return cabac_.decision(16) ? 3 : 0;  // P_8x8 : 16x16
}

// B mb_type: 0 direct, 1..21 inter, 22 B_8x8, 23 + i for intra code i.
int EntropyDecoder::cabac_mb_type_b(int mb_x, int mb_y) {
  MbCtx* a = nba_;
  MbCtx* b = nbb_;
  int inc = (a && !a->skip && !a->is_direct16 ? 1 : 0) +
            (b && !b->skip && !b->is_direct16 ? 1 : 0);
  if (!cabac_.decision(27 + inc)) return 0;  // B_Direct_16x16
  if (!cabac_.decision(27 + 3)) return 1 + cabac_.decision(27 + 5);
  int bits = cabac_.decision(27 + 4) << 3;
  bits |= cabac_.decision(27 + 5) << 2;
  bits |= cabac_.decision(27 + 5) << 1;
  bits |= cabac_.decision(27 + 5);
  if (bits < 8) return bits + 3;
  if (bits == 13) return 23 + cabac_mb_type_i(32, false, 0, 0);
  if (bits == 14) return 11;  // B_L1_L0_8x16
  if (bits == 15) return 22;  // B_8x8
  bits = (bits << 1) | cabac_.decision(27 + 5);
  return bits - 4;  // 12..21
}

int EntropyDecoder::cabac_sub_mb_type_p() {
  if (cabac_.decision(21)) return 0;   // 8x8
  if (!cabac_.decision(22)) return 1;  // 8x4
  return cabac_.decision(23) ? 2 : 3;  // 4x8 : 4x4
}

int EntropyDecoder::cabac_sub_mb_type_b() {
  if (!cabac_.decision(36)) return 0;  // B_Direct_8x8
  if (!cabac_.decision(37)) return 1 + cabac_.decision(39);
  int type = 3;
  if (cabac_.decision(38)) {
    if (cabac_.decision(39)) return 11 + cabac_.decision(39);
    type += 4;
  }
  type += 2 * cabac_.decision(39);
  type += cabac_.decision(39);
  return type;
}

EntropyDecoder::CellRef EntropyDecoder::cell(int list, int cx, int cy) {
  CellRef r;
  if (cx < 0 || cy < 0 || cx >= 4 * mb_w_ || cy >= 4 * mb_h_) return r;
  MbCtx* m = avail(cx >> 2, cy >> 2);
  if (!m) return r;
  r.avail = true;
  r.intra = m->intra;
  if (m->uniform) {
    r.ref = m->uniform_ref[list];
    r.mv[0] = m->uniform_mv[list][0];
    r.mv[1] = m->uniform_mv[list][1];
    return r;
  }
  int idx = (cy & 3) * 4 + (cx & 3);
  r.ref = m->ref4[list][idx];
  r.mv[0] = m->mv4[list][idx][0];
  r.mv[1] = m->mv4[list][idx][1];
  return r;
}

int EntropyDecoder::cabac_ref_idx(int list, int cx, int cy) {
  // 9.3.3.1.1.6: condTermFlagN = neighbor partition explicitly uses
  // list with ref > 0 (B direct neighbors excluded).
  auto flag = [&](int nx, int ny) -> int {
    if (nx < 0 || ny < 0 || nx >= 4 * mb_w_ || ny >= 4 * mb_h_) return 0;
    MbCtx* m = avail(nx >> 2, ny >> 2);
    if (!m || m->intra) return 0;
    int idx = (ny & 3) * 4 + (nx & 3);
    if (m->direct_mask & (1u << idx)) return 0;
    return m->ref4[list][idx] > 0 ? 1 : 0;
  };
  int ctx = flag(cx - 1, cy) + 2 * flag(cx, cy - 1);
  int ref = 0;
  int c = 54 + ctx;
  while (cabac_.decision(c)) {
    ref++;
    c = 54 + (ref == 1 ? 4 : 5);
    if (ref > 31) break;  // corrupt stream guard
  }
  if (trace_level() >= 2) fprintf(stderr, "R list=%d ref=%d\n", list, ref);
  return ref;
}

void EntropyDecoder::cabac_mvd_pair(int list, int cx, int cy, int out[2]) {
  // Both components share the 9.3.3.1.1.7 neighbor cells (left/top of
  // the partition origin; nothing this partition writes before the
  // publish step) — fetch each neighbor once and derive both ctxIncs.
  int sum[2] = {0, 0};
  auto accum = [&](int nx, int ny) {
    if (nx < 0 || ny < 0 || nx >= 4 * mb_w_ || ny >= 4 * mb_h_) return;
    MbCtx* m = avail(nx >> 2, ny >> 2);
    if (!m || m->intra) return;
    if (m->uniform) return;  // skip/direct fills carry zero mvd
    int idx = (ny & 3) * 4 + (nx & 3);
    if (m->ref4[list][idx] < 0) return;
    sum[0] += std::abs((int)m->mvd4[list][idx][0]);
    sum[1] += std::abs((int)m->mvd4[list][idx][1]);
  };
  accum(cx - 1, cy);
  accum(cx, cy - 1);
  for (int comp = 0; comp < 2; comp++) {
    int inc = sum[comp] < 3 ? 0 : (sum[comp] > 32 ? 2 : 1);
    int base = comp == 0 ? 40 : 47;
    if (!cabac_.decision(base + inc)) {
      out[comp] = 0;
      continue;
    }
    // UEG3 prefix: TU up to 8 more ones with ctxs +3..+6.
    int n = 1;
    while (n < 9) {
      int c = base + 2 + std::min(n, 4);  // bins 1,2,3,>=4 -> +3,+4,+5,+6
      if (!cabac_.decision(c)) break;
      n++;
    }
    int val;
    if (n == 9)
      val = 9 + (int)cabac_.bypass_eg(3);
    else
      val = n;
    int sign = cabac_.bypass();
    out[comp] = sign ? -val : val;
  }
}

int EntropyDecoder::cabac_cbp_luma(int mb_x, int mb_y) {
  // Neighbor 8x8 cbp bits; unavailable -> treated as coded (ctx 0).
  MbCtx* a = nba_;
  MbCtx* b = nbb_;
  auto abit = [&](int blk) -> int {  // left MB bit for our row blk
    if (!a) return 1;               // treated as coded
    if (a->pcm) return 1;
    return (a->cbp_luma >> blk) & 1;
  };
  auto bbit = [&](int blk) -> int {
    if (!b) return 1;
    if (b->pcm) return 1;
    return (b->cbp_luma >> blk) & 1;
  };
  int cbp = 0;
  // block 0: left = left MB blk1, top = top MB blk2
  int ctx = (abit(1) ? 0 : 1) + 2 * (bbit(2) ? 0 : 1);
  cbp |= cabac_.decision(73 + ctx);
  // block 1: left = our blk0, top = top MB blk3
  ctx = ((cbp & 1) ? 0 : 1) + 2 * (bbit(3) ? 0 : 1);
  cbp |= cabac_.decision(73 + ctx) << 1;
  // block 2: left = left MB blk3, top = our blk0
  ctx = (abit(3) ? 0 : 1) + 2 * ((cbp & 1) ? 0 : 1);
  cbp |= cabac_.decision(73 + ctx) << 2;
  // block 3: left = our blk2, top = our blk1
  ctx = ((cbp & 4) ? 0 : 1) + 2 * ((cbp & 2) ? 0 : 1);
  cbp |= cabac_.decision(73 + ctx) << 3;
  return cbp;
}

int EntropyDecoder::cabac_cbp_chroma(int mb_x, int mb_y) {
  MbCtx* cur = &mbs_[plane_off_ + (size_t)mb_y * mb_w_ + mb_x];
  MbCtx* a = nba_;
  MbCtx* b = nbb_;
  (void)cur;
  // Unavailable neighbors contribute 0 to the chroma cbp contexts
  // regardless of the current MB type (libavcodec's missing-neighbor cbp
  // fill 0x7CF/0x00F has the chroma bits 4-5 clear in both variants —
  // verified against a CABAC bin trace of the reference decoder).
  auto nz = [&](MbCtx* m) -> int {
    if (!m) return 0;
    if (m->pcm) return 1;
    return m->cbp_chroma != 0;
  };
  auto two = [&](MbCtx* m) -> int {
    if (!m) return 0;
    if (m->pcm) return 1;
    return m->cbp_chroma == 2;
  };
  int ctx = nz(a) + 2 * nz(b);
  if (!cabac_.decision(77 + ctx)) return 0;
  ctx = two(a) + 2 * two(b);
  return 1 + cabac_.decision(81 + ctx);
}

int EntropyDecoder::cabac_qp_delta() {
  int ctx = last_qp_delta_ != 0 ? 1 : 0;
  int val = 0;
  int c = 60 + ctx;
  while (cabac_.decision(c)) {
    val++;
    c = 60 + (val == 1 ? 2 : 3);
    if (val > 112) break;
  }
  return (val & 1) ? (val + 1) / 2 : -(val / 2);
}

int EntropyDecoder::cabac_intra_chroma_mode(int mb_x, int mb_y) {
  MbCtx* a = nba_;
  MbCtx* b = nbb_;
  int ctx = (a && a->intra && !a->pcm && a->chroma_mode != 0 ? 1 : 0) +
            (b && b->intra && !b->pcm && b->chroma_mode != 0 ? 1 : 0);
  if (!cabac_.decision(64 + ctx)) return 0;
  if (!cabac_.decision(67)) return 1;
  return 2 + cabac_.decision(67);
}

int EntropyDecoder::cabac_transform_8x8(int mb_x, int mb_y) {
  MbCtx* a = nba_;
  MbCtx* b = nbb_;
  int ctx = (a && a->t8x8 ? 1 : 0) + (b && b->t8x8 ? 1 : 0);
  return cabac_.decision(399 + ctx);
}

// condTermFlag for coded_block_flag neighbors. kind: 0 luma-plane DC
// (comp = plane), 1 luma-plane 4x4 (comp = plane, blk), 2 chroma DC
// (comp), 3 chroma AC (comp, blk).
int EntropyDecoder::cbf_cond(MbCtx* n, bool cur_intra, int kind, int comp,
                             int blk) {
  if (!n) return cur_intra ? 1 : 0;  // unavailable (9.3.3.1.1.9)
  if (n->pcm) return 1;
  if (n->skip) return 0;
  switch (kind) {
    case 0:  // plane DC block exists only in Intra16x16 MBs
      return n->i16 ? ((n->cbf_luma_dc >> comp) & 1) : 0;
    case 1:
      return (n->cbf_luma[comp] >> blk) & 1;
    case 2:
      return n->cbp_chroma != 0 ? ((n->cbf_chroma_dc >> comp) & 1) : 0;
    case 3:
      return n->cbp_chroma == 2 ? ((n->cbf_chroma_ac[comp] >> blk) & 1) : 0;
  }
  return 0;
}

int EntropyDecoder::cbf_ctx_luma_dc(int mb_x, int mb_y, int plane) {
  MbCtx* cur = &mbs_[plane_off_ + (size_t)mb_y * mb_w_ + mb_x];
  int a = cbf_cond(nba_, cur->intra, 0, plane, 0);
  int b = cbf_cond(nbb_, cur->intra, 0, plane, 0);
  return a + 2 * b;
}

int EntropyDecoder::cbf_ctx_luma4x4(int mb_x, int mb_y, int blk, int plane) {
  MbCtx* cur = &mbs_[plane_off_ + (size_t)mb_y * mb_w_ + mb_x];
  int x4 = blk & 3, y4 = blk >> 2;
  int a, b;
  if (x4 > 0) {
    a = (cur->cbf_luma[plane] >> (blk - 1)) & 1;
  } else {
    a = cbf_cond(nba_, cur->intra, 1, plane, y4 * 4 + 3);
  }
  if (y4 > 0) {
    b = (cur->cbf_luma[plane] >> (blk - 4)) & 1;
  } else {
    b = cbf_cond(nbb_, cur->intra, 1, plane, 12 + x4);
  }
  return a + 2 * b;
}

// cbf ctxInc for an 8x8 block (ctxBlockCat 5/9/13, present only in
// 4:4:4): per 9.3.3.1.1.9 the neighbor transform block is the adjacent
// 8x8 ONLY when that macroblock is 8x8-transformed; a 4x4-transformed
// neighbor MB leaves the block unavailable (condTerm 0), while PCM is 1
// and an unavailable MB follows the usual intra rule. Coded 8x8s mark
// all four 4x4 cells with their cbf, so reading the corner cell of the
// neighbor 8x8 yields its flag.
int EntropyDecoder::cbf_ctx_luma8x8(int mb_x, int mb_y, int i8, int plane) {
  MbCtx* cur = &mbs_[plane_off_ + (size_t)mb_y * mb_w_ + mb_x];
  auto cond = [&](bool left) -> int {
    int nb8;  // neighbor 8x8 index
    MbCtx* m;
    if (left) {
      if (i8 & 1) {
        m = cur;
        nb8 = i8 - 1;
      } else {
        m = nba_;
        nb8 = i8 + 1;
      }
    } else {
      if (i8 >= 2) {
        m = cur;
        nb8 = i8 - 2;
      } else {
        m = nbb_;
        nb8 = i8 + 2;
      }
    }
    if (!m) return cur->intra ? 1 : 0;
    if (m != cur) {
      if (m->pcm) return 1;
      if (m->skip || !m->t8x8) return 0;
    }
    return (m->cbf_luma[plane] >> blk_raster(nb8, 0)) & 1;
  };
  return cond(true) + 2 * cond(false);
}

int EntropyDecoder::cbf_ctx_chroma_dc(int mb_x, int mb_y, int comp) {
  MbCtx* cur = &mbs_[plane_off_ + (size_t)mb_y * mb_w_ + mb_x];
  int a = cbf_cond(nba_, cur->intra, 2, comp, 0);
  int b = cbf_cond(nbb_, cur->intra, 2, comp, 0);
  return a + 2 * b;
}

int EntropyDecoder::cbf_ctx_chroma_ac(int mb_x, int mb_y, int comp, int blk) {
  // Chroma AC blocks form a 2-wide grid: 2x2 in 4:2:0, 2x4 in 4:2:2.
  MbCtx* cur = &mbs_[plane_off_ + (size_t)mb_y * mb_w_ + mb_x];
  int x2 = blk & 1, y2 = blk >> 1;
  int last_row = ch_ac_blocks() / 2 - 1;
  int a, b;
  if (x2 > 0) {
    a = (cur->cbf_chroma_ac[comp] >> (blk - 1)) & 1;
  } else {
    a = cbf_cond(nba_, cur->intra, 3, comp, y2 * 2 + 1);
  }
  if (y2 > 0) {
    b = (cur->cbf_chroma_ac[comp] >> (blk - 2)) & 1;
  } else {
    b = cbf_cond(nbb_, cur->intra, 3, comp,
                 last_row * 2 + x2);
  }
  return a + 2 * b;
}

int EntropyDecoder::residual_block(int cat, int max_coeff, int cbf_ctx_inc,
                                   bool has_cbf, int* cbf_out) {
  if (has_cbf) {
    int cbf = cabac_.decision(kCbfBase[cat] + cbf_ctx_inc);
    *cbf_out = cbf;
    if (!cbf) return 0;
  } else {
    *cbf_out = 1;
  }
  bool is8x8 = cat == 5 || cat == 9 || cat == 13;
  // Field-coded macroblocks (MBAFF) select the Table 9-34 field
  // ctxIdxOffset rows and the Table 9-43 field 8x8 inc mapping;
  // resid_field_ is constant-false on the progressive path (branch-free
  // selects, no measurable cost).
  int sig_base = (resid_field_ ? kSigBaseField : kSigBase)[cat];
  int last_base = (resid_field_ ? kLastBaseField : kLastBase)[cat];
  const uint8_t* sig8 = resid_field_ ? kSigCtx8x8Field : kSigCtx8x8;
  int abs_base = kAbsBase[cat];
  int count = 0, last = -1;
  // Specialized significance loops (hot: ~2M calls/clip) — the ctxIdxInc
  // source is loop-invariant, so pick the variant up front instead of
  // re-branching per scan position.
  if (is8x8) {
    for (int i = 0; i < max_coeff - 1; i++)
      if (cabac_.decision(sig_base + sig8[i])) {
        count++;
        if (cabac_.decision(last_base + kLastCtx8x8[i])) {
          last = i;
          break;
        }
      }
  } else if (cat == 3) {
    // Chroma DC sig/last ctxIdxInc = Min(i / NumC8x8, 2) with
    // NumC8x8 = max_coeff/4 (9.3.3.1.3: 1 for 4:2:0, 2 for 4:2:2).
    int c8 = max_coeff >> 2;
    for (int i = 0; i < max_coeff - 1; i++) {
      int inc = std::min(i / c8, 2);
      if (cabac_.decision(sig_base + inc)) {
        count++;
        if (cabac_.decision(last_base + inc)) {
          last = i;
          break;
        }
      }
    }
  } else {
    for (int i = 0; i < max_coeff - 1; i++)
      if (cabac_.decision(sig_base + i)) {
        count++;
        if (cabac_.decision(last_base + i)) {
          last = i;
          break;
        }
      }
  }
  if (last < 0) count++;
  // Levels, reverse scan order. The context evolution (eq1/gt1) depends
  // only on the sequence of magnitudes, not on scan positions — so
  // iterate `count` times; no significance map needs materializing.
  int eq1 = 0, gt1 = 0;
  int ctx_n_cap = 4 - (cat == 3 ? 1 : 0);
  for (int k = 0; k < count; k++) {
    int ctx0 = (gt1 != 0) ? 0 : std::min(4, 1 + eq1);
    int abs_m1;
    if (!cabac_.decision(abs_base + ctx0)) {
      abs_m1 = 0;
    } else {
      int ctx_n = abs_base + 5 + std::min(ctx_n_cap, gt1);
      int ones = 1;
      while (ones < 14 && cabac_.decision(ctx_n)) ones++;
      abs_m1 = (ones == 14) ? 14 + (int)cabac_.bypass_eg(0) : ones;
    }
    cabac_.bypass();  // sign
    if (abs_m1 == 0)
      eq1++;
    else
      gt1++;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Motion vector prediction (8.4.1)
// ---------------------------------------------------------------------------

static void median3(const int16_t a[2], const int16_t b[2], const int16_t c[2],
                    int16_t out[2]) {
  for (int k = 0; k < 2; k++) {
    int x = a[k], y = b[k], z = c[k];
    out[k] = (int16_t)(std::max(std::min(x, y),
                                std::min(std::max(x, y), z)));
  }
}

void EntropyDecoder::median_pred(int list, int ref, int x0, int y0, int w,
                                 int h, int part_kind, int16_t* pred) {
  // part_kind: 0 generic, 1 = 16x8 top, 2 = 16x8 bottom, 3 = 8x16 left,
  // 4 = 8x16 right (directional shortcuts, 8.4.1.3.1).
  CellRef A = cell(list, x0 - 1, y0);
  CellRef B = cell(list, x0, y0 - 1);
  CellRef C = cell(list, x0 + w, y0 - 1);
  bool c_from_d = false;
  if (!C.avail) {
    C = cell(list, x0 - 1, y0 - 1);
    c_from_d = true;
  }
  (void)c_from_d;

  auto uses = [&](const CellRef& r) { return r.avail && !r.intra && r.ref >= 0; };
  auto matches = [&](const CellRef& r) { return uses(r) && r.ref == ref; };

  // Directional rules for 16x8 / 8x16 partitions.
  if (part_kind == 1 && matches(B)) {
    pred[0] = B.mv[0];
    pred[1] = B.mv[1];
    return;
  }
  if (part_kind == 2 && matches(A)) {
    pred[0] = A.mv[0];
    pred[1] = A.mv[1];
    return;
  }
  if (part_kind == 3 && matches(A)) {
    pred[0] = A.mv[0];
    pred[1] = A.mv[1];
    return;
  }
  if (part_kind == 4 && matches(C)) {
    pred[0] = C.mv[0];
    pred[1] = C.mv[1];
    return;
  }

  // If B, C (and D) unavailable but A available: use A.
  if (!B.avail && !C.avail && A.avail) {
    pred[0] = uses(A) ? A.mv[0] : 0;
    pred[1] = uses(A) ? A.mv[1] : 0;
    return;
  }
  // Exactly one neighbor referencing the same picture: take it.
  int m = matches(A) + matches(B) + matches(C);
  if (m == 1) {
    const CellRef& r = matches(A) ? A : (matches(B) ? B : C);
    pred[0] = r.mv[0];
    pred[1] = r.mv[1];
    return;
  }
  int16_t ma[2] = {uses(A) ? A.mv[0] : (int16_t)0, uses(A) ? A.mv[1] : (int16_t)0};
  int16_t mb[2] = {uses(B) ? B.mv[0] : (int16_t)0, uses(B) ? B.mv[1] : (int16_t)0};
  int16_t mc[2] = {uses(C) ? C.mv[0] : (int16_t)0, uses(C) ? C.mv[1] : (int16_t)0};
  median3(ma, mb, mc, pred);
}

// ---------------------------------------------------------------------------
// DPB emulation (POC, ref lists, colocated storage) for exact B-direct
// MV export. POC types 0/1/2, long-term references, and MMCO 1-6 are
// all modeled (validated MV-exact vs libavcodec, tools/dpb_gen.py).
// Parsing never depends on the model: the few shapes that degrade
// dpb_valid_ (direct MVs then fall back to plain spatial prediction)
// are exactly those libavcodec — the only oracle AND the reference's
// decoder family — cannot represent or handles unverifiably: field
// IDR long_term_reference_flag, field MMCO 5/6, mixed-parity field
// marking, and MMCO 5 under POC type 1/2 (rationales at each site).
// ---------------------------------------------------------------------------

void EntropyDecoder::compute_poc(int nal_type, int nal_ref_idc) {
  const Sps& sps = *active_sps_;
  bool idr = nal_type == NAL_SLICE_IDR;
  if (idr) {
    dpb_.clear();
    dpb_valid_ = true;
    prev_poc_msb_ = 0;
    prev_poc_lsb_ = 0;
    prev_frame_num_ = 0;
    prev_frame_num_offset_ = 0;
    max_lt_idx_ = -1;
  }
  cur_is_ref_ = nal_ref_idc != 0;
  if (sps.pic_order_cnt_type == 0) {
    // 8.2.1.1 (frames only).
    int max_lsb = 1 << sps.log2_max_poc_lsb;
    int lsb = sh_.pic_order_cnt_lsb;
    int32_t msb;
    if (lsb < prev_poc_lsb_ && prev_poc_lsb_ - lsb >= max_lsb / 2)
      msb = prev_poc_msb_ + max_lsb;
    else if (lsb > prev_poc_lsb_ && lsb - prev_poc_lsb_ > max_lsb / 2)
      msb = prev_poc_msb_ - max_lsb;
    else
      msb = prev_poc_msb_;
    cur_poc_ = msb + lsb;
    if (cur_is_ref_) {
      prev_poc_msb_ = msb;
      prev_poc_lsb_ = lsb;
    }
  } else if (sps.pic_order_cnt_type == 2) {
    cur_poc_ = 2 * sh_.frame_num - (cur_is_ref_ ? 0 : 1);
  } else {
    // 8.2.1.2 (POC type 1): expected POC from the frame_num cycle plus
    // the slice's delta_pic_order_cnt[0].
    int max_frame_num = 1 << sps.log2_max_frame_num;
    int32_t fno = prev_frame_num_offset_;
    if (sh_.frame_num < prev_frame_num_) fno += max_frame_num;
    int cycle = (int)sps.offset_for_ref_frame.size();
    int64_t abs_fn = cycle ? (int64_t)fno + sh_.frame_num : 0;
    if (!cur_is_ref_ && abs_fn > 0) abs_fn -= 1;
    int64_t expected = 0;
    if (abs_fn > 0) {
      int64_t cycle_cnt = (abs_fn - 1) / cycle;
      int in_cycle = (int)((abs_fn - 1) % cycle);
      int64_t per_cycle = 0;
      for (int i = 0; i < cycle; i++) per_cycle += sps.offset_for_ref_frame[i];
      expected = cycle_cnt * per_cycle;
      for (int i = 0; i <= in_cycle; i++)
        expected += sps.offset_for_ref_frame[i];
    }
    if (!cur_is_ref_) expected += sps.offset_for_non_ref_pic;
    if (field_pic_ && bottom_field_)
      expected += sps.offset_for_top_to_bottom_field;
    cur_poc_ = (int32_t)(expected + sh_.delta_pic_order_cnt0);
    prev_frame_num_ = sh_.frame_num;
    prev_frame_num_offset_ = fno;
  }
  // BottomFieldOrderCnt (8.2.1): TopFieldOrderCnt +
  // delta_pic_order_cnt_bottom for poc-type-0 frames, + offset_for_
  // top_to_bottom_field (+ delta[1], parsed into the same field) for
  // poc-type-1 frames; equal otherwise. A FIELD picture has exactly
  // one order count (its own).
  cur_poc_bot_ = cur_poc_;
  if (!field_pic_) {
    if (sps.pic_order_cnt_type == 0)
      cur_poc_bot_ += sh_.delta_poc_bottom;
    else if (sps.pic_order_cnt_type == 1)
      cur_poc_bot_ += sps.offset_for_top_to_bottom_field;
  }
  // Field marking is modeled in the field PicNum domain
  // (2*FrameNumWrap(+1), 8.2.4.1) for MMCO 1/2/3/4 and homogeneous
  // long-term field pairs. Degradations (parse sync never depends on
  // the motion model): MMCO 5 (reset, as for frames under POC 1/2);
  // MMCO 6 and the IDR long_term_reference_flag on FIELDS — libavcodec
  // (the oracle AND the reference's decoder) tracks references
  // frame-granularly and cannot represent the mixed-parity pair these
  // create (observed: "illegal short term reference assignment...",
  // missing-reference list underflow on the canonical lt_flag + MMCO 6
  // pattern), so there is no validation path.
  if (field_pic_) {
    if (sh_.longterm_reference) dpb_valid_ = false;
    for (const auto& op : sh_.mmco)
      if (op[0] == 5 || op[0] == 6) dpb_valid_ = false;
  }
}

void EntropyDecoder::build_ref_lists() {
  l0_.clear();
  l1_.clear();
  if (!dpb_valid_ || dpb_.empty()) return;
  const Sps& sps = *active_sps_;
  int max_frame_num = 1 << sps.log2_max_frame_num;

  auto frame_num_wrap = [&](const RefPic& r) {
    return r.frame_num > sh_.frame_num ? r.frame_num - max_frame_num
                                       : r.frame_num;
  };

  // DPB holds at most max_num_ref_frames (<= 16) pictures;
  // fixed-capacity scratch + stable insertion sorts avoid three heap
  // allocations per slice (hot: once per slice, ~5.4K/clip).
  // Short-term and long-term references are split: the initial lists
  // are short-terms in their 8.2.4.2 order followed by long-terms
  // ascending by LongTermFrameIdx.
  const RefPic* refs[17];
  const RefPic* longs[17];
  size_t nrefs = 0, nlongs = 0;
  for (const auto& r : dpb_) {
    if (r.longterm) {
      if (nlongs < 17) longs[nlongs++] = &r;
    } else if (nrefs < 17) {
      refs[nrefs++] = &r;
    }
  }
  // Stable insertion sort of refs[lo, hi) by strict-weak `less`.
  auto ins_sort = [](const RefPic** a, size_t n, auto less) {
    for (size_t i = 1; i < n; i++) {
      const RefPic* key = a[i];
      size_t j = i;
      while (j > 0 && less(key, a[j - 1])) {
        a[j] = a[j - 1];
        j--;
      }
      a[j] = key;
    }
  };

  // Long-term tail shared by P and B initial lists (8.2.4.2.1/.3:
  // ascending LongTermFrameIdx, appended after the short-terms).
  ins_sort(longs, nlongs, [](const RefPic* a, const RefPic* b) {
    return a->lt_idx < b->lt_idx;
  });

  if (field_pic_) {
    // Field reference lists (8.2.4.2.2/8.2.4.2.4 frame ordering +
    // 8.2.4.2.5 parity interleave, incl. long-term field tails);
    // reordering ops apply below in the field PicNum domain.
    build_ref_lists_field();
  } else if (sh_.type == SLICE_P) {
    // 8.2.4.2.1: descending PicNum (== FrameNumWrap for frames).
    ins_sort(refs, nrefs, [&](const RefPic* a, const RefPic* b) {
      return frame_num_wrap(*a) > frame_num_wrap(*b);
    });
    l0_.assign(refs, refs + nrefs);
    l0_.insert(l0_.end(), longs, longs + nlongs);
  } else if (sh_.type == SLICE_B) {
    // 8.2.4.2.3: L0 = past by descending POC, then future ascending;
    // L1 = future ascending, then past descending.
    const RefPic* past[17];
    const RefPic* fut[17];
    size_t npast = 0, nfut = 0;
    for (size_t i = 0; i < nrefs; i++)
      (refs[i]->poc <= cur_poc_ ? past[npast++] : fut[nfut++]) = refs[i];
    ins_sort(past, npast,
             [](const RefPic* a, const RefPic* b) { return a->poc > b->poc; });
    ins_sort(fut, nfut,
             [](const RefPic* a, const RefPic* b) { return a->poc < b->poc; });
    l0_.clear();
    l0_.insert(l0_.end(), past, past + npast);
    l0_.insert(l0_.end(), fut, fut + nfut);
    l0_.insert(l0_.end(), longs, longs + nlongs);
    l1_.clear();
    l1_.insert(l1_.end(), fut, fut + nfut);
    l1_.insert(l1_.end(), past, past + npast);
    l1_.insert(l1_.end(), longs, longs + nlongs);
    if (l1_.size() > 1 && l1_ == l0_) std::swap(l1_[0], l1_[1]);
  }

  // 8.2.4.3 reordering ops: idc 0/1 pick a short-term by PicNum
  // (8.2.4.3.1), idc 2 a long-term by LongTermPicNum (8.2.4.3.2; does
  // not touch picNumPred). Frames use FrameNumWrap / LongTermFrameIdx;
  // field slices the 2x(+1-for-same-parity) field domain (8.2.4.1).
  auto apply_mods = [&](std::vector<const RefPic*>& list, int lx) {
    if (sh_.list_mod[lx].empty()) return;
    int cur_parity = field_pic_ ? (bottom_field_ ? 2 : 1) : 0;
    int max_pic_num = field_pic_ ? 2 * max_frame_num : max_frame_num;
    int cur_pic_num = field_pic_ ? 2 * sh_.frame_num + 1 : sh_.frame_num;
    auto pic_num_of = [&](const RefPic& r) {
      if (!field_pic_) return frame_num_wrap(r);
      return 2 * frame_num_wrap(r) + (r.parity == cur_parity ? 1 : 0);
    };
    auto lt_num_of = [&](const RefPic& r) {
      if (!field_pic_) return r.lt_idx;
      return 2 * r.lt_idx + (r.parity == cur_parity ? 1 : 0);
    };
    int pic_num_pred = cur_pic_num;
    size_t insert_at = 0;
    for (auto [idc, val] : sh_.list_mod[lx]) {
      const RefPic* hit = nullptr;
      if (idc == 2) {
        for (size_t i = 0; i < nlongs; i++)
          if (lt_num_of(*longs[i]) == val) hit = longs[i];
      } else {
        if (idc == 0) {
          pic_num_pred -= val + 1;
          if (pic_num_pred < 0) pic_num_pred += max_pic_num;
        } else {
          pic_num_pred += val + 1;
          if (pic_num_pred >= max_pic_num) pic_num_pred -= max_pic_num;
        }
        int target = pic_num_pred > cur_pic_num
                         ? pic_num_pred - max_pic_num
                         : pic_num_pred;
        for (size_t i = 0; i < nrefs; i++)
          if (pic_num_of(*refs[i]) == target) hit = refs[i];
      }
      if (!hit) continue;  // non-conforming; keep going
      if (insert_at > list.size()) insert_at = list.size();
      list.insert(list.begin() + insert_at, hit);
      insert_at++;
      for (size_t i = insert_at; i < list.size(); i++)
        if (list[i] == hit) {
          list.erase(list.begin() + i);
          break;
        }
    }
  };
  apply_mods(l0_, 0);
  apply_mods(l1_, 1);
  // Lists are truncated to the active count (8.2.4.2): entries beyond
  // num_ref_idx are not addressable, and the temporal-direct poc->index
  // mapping must not match them.
  if ((int)l0_.size() > sh_.num_ref_idx_l0) l0_.resize(sh_.num_ref_idx_l0);
  if (sh_.type == SLICE_B && (int)l1_.size() > sh_.num_ref_idx_l1)
    l1_.resize(sh_.num_ref_idx_l1);

  // Record this slice's referenced-POC tables for store_ref_picture.
  if ((size_t)slice_id_ >= slice_list_pocs_.size())
    slice_list_pocs_.resize(slice_id_ + 1);
  for (int lx = 0; lx < 2; lx++) {
    auto& v = slice_list_pocs_[slice_id_][lx];
    v.clear();
    for (auto* r : (lx == 0 ? l0_ : l1_)) v.push_back(r->poc);
  }
}

void EntropyDecoder::build_ref_lists_field() {
  // Field reference lists, current picture a PAFF field. Mixed DPBs
  // (frame reference pictures still buffered — a progressive-to-PAFF
  // switch inside one GoP) would need the 8.2.4.2.5 frame-to-field
  // split of frame-grid snapshots; degrade instead (lists empty,
  // direct modes fall back to spatial prediction).
  for (const auto& r : dpb_)
    if (r.parity == 0) return;

  int max_frame_num = 1 << active_sps_->log2_max_frame_num;
  // Group complementary pairs — adjacent in decode order, same
  // frame_num, opposite parity — into frame slots (fld[0] top field,
  // fld[1] bottom field; unpaired fields leave the other slot null).
  struct FieldFrame {
    const RefPic* fld[2] = {nullptr, nullptr};
    int fnw = 0;
    int32_t poc = 0;  // PicOrderCnt of the frame: min of its fields
  };
  FieldFrame frames[17];
  size_t nf = 0;
  for (const auto& r : dpb_) {
    if (r.longterm) continue;  // long-term tail built separately below
    int slot = r.parity == 2 ? 1 : 0;
    if (nf > 0 && frames[nf - 1].fld[slot] == nullptr &&
        frames[nf - 1].fld[1 - slot] != nullptr &&
        frames[nf - 1].fld[1 - slot]->frame_num == r.frame_num) {
      frames[nf - 1].fld[slot] = &r;
      frames[nf - 1].poc = std::min(frames[nf - 1].poc, r.poc);
      continue;
    }
    if (nf >= 17) break;
    frames[nf].fld[slot] = &r;
    frames[nf].fld[1 - slot] = nullptr;
    frames[nf].fnw = r.frame_num > sh_.frame_num
                         ? r.frame_num - max_frame_num
                         : r.frame_num;
    frames[nf].poc = r.poc;
    nf++;
  }

  // Long-term fields: grouped into complementary pairs by
  // LongTermFrameIdx (fnw doubles as the sort key), ordered ascending
  // (8.2.4.2.2 refFrameListLongTerm), parity-interleaved like the
  // short-term groups (8.2.4.2.5) and appended to every list.
  FieldFrame lframes[17];
  size_t nlf = 0;
  for (const auto& r : dpb_) {
    if (!r.longterm) continue;
    int slot = r.parity == 2 ? 1 : 0;
    bool merged = false;
    for (size_t i = 0; i < nlf; i++)
      if (lframes[i].fnw == r.lt_idx && lframes[i].fld[slot] == nullptr) {
        lframes[i].fld[slot] = &r;
        merged = true;
        break;
      }
    if (merged) continue;
    if (nlf >= 17) break;
    lframes[nlf].fld[slot] = &r;
    lframes[nlf].fld[1 - slot] = nullptr;
    lframes[nlf].fnw = r.lt_idx;
    lframes[nlf].poc = r.poc;
    nlf++;
  }

  auto ins_sort = [](FieldFrame* a, size_t n, auto less) {
    for (size_t i = 1; i < n; i++) {
      FieldFrame key = a[i];
      size_t j = i;
      while (j > 0 && less(key, a[j - 1])) {
        a[j] = a[j - 1];
        j--;
      }
      a[j] = key;
    }
  };

  // 8.2.4.2.5: alternate parities over the ordered frame list, same
  // parity as the current field first; when one parity exhausts, the
  // remaining fields of the other follow in frame order.
  auto interleave = [&](const FieldFrame* fr, size_t n,
                        std::vector<const RefPic*>& out) {
    int want = bottom_field_ ? 1 : 0;
    const RefPic* same[17];
    const RefPic* opp[17];
    size_t ns = 0, no = 0;
    for (size_t i = 0; i < n; i++) {
      if (fr[i].fld[want]) same[ns++] = fr[i].fld[want];
      if (fr[i].fld[1 - want]) opp[no++] = fr[i].fld[1 - want];
    }
    out.clear();
    for (size_t i = 0, j = 0; i < ns || j < no;) {
      if (i < ns) out.push_back(same[i++]);
      if (j < no) out.push_back(opp[j++]);
    }
  };

  // Ascending-LongTermFrameIdx tail, interleaved once and appended to
  // whichever lists get built below.
  ins_sort(lframes, nlf, [](const FieldFrame& a, const FieldFrame& b) {
    return a.fnw < b.fnw;
  });
  std::vector<const RefPic*> ltail;
  interleave(lframes, nlf, ltail);

  if (sh_.type == SLICE_P) {
    // 8.2.4.2.2: frames by descending FrameNumWrap.
    ins_sort(frames, nf, [](const FieldFrame& a, const FieldFrame& b) {
      return a.fnw > b.fnw;
    });
    interleave(frames, nf, l0_);
    l0_.insert(l0_.end(), ltail.begin(), ltail.end());
  } else if (sh_.type == SLICE_B) {
    // 8.2.4.2.4: past (POC <= current field's) descending, then future
    // ascending for L0; mirrored for L1 — each then parity-interleaved.
    FieldFrame past[17], fut[17];
    size_t npast = 0, nfut = 0;
    for (size_t i = 0; i < nf; i++)
      (frames[i].poc <= cur_poc_ ? past[npast++] : fut[nfut++]) = frames[i];
    ins_sort(past, npast, [](const FieldFrame& a, const FieldFrame& b) {
      return a.poc > b.poc;
    });
    ins_sort(fut, nfut, [](const FieldFrame& a, const FieldFrame& b) {
      return a.poc < b.poc;
    });
    FieldFrame ordered[34];
    for (size_t i = 0; i < npast; i++) ordered[i] = past[i];
    for (size_t i = 0; i < nfut; i++) ordered[npast + i] = fut[i];
    interleave(ordered, npast + nfut, l0_);
    l0_.insert(l0_.end(), ltail.begin(), ltail.end());
    for (size_t i = 0; i < nfut; i++) ordered[i] = fut[i];
    for (size_t i = 0; i < npast; i++) ordered[nfut + i] = past[i];
    interleave(ordered, npast + nfut, l1_);
    l1_.insert(l1_.end(), ltail.begin(), ltail.end());
    if (l1_.size() > 1 && l1_ == l0_) std::swap(l1_[0], l1_[1]);
  }
}

// Copy one macroblock's motion into a RefPic snapshot slot (shared by
// the inline snap_mb path and store_ref_picture's fallback walk).
static inline void snap_mb_into(const MbCtx& m, size_t i, RefPic* pic,
                                int cells, bool corners) {
  int8_t* rp = &pic->ref4[i * 2 * cells];
  int16_t* mp = &pic->mv4[i * 4 * cells];
  static const int kCorner[4] = {0, 3, 12, 15};
  if (m.uniform) {
    for (int lx = 0; lx < 2; lx++)
      for (int k = 0; k < cells; k++) {
        rp[lx * cells + k] = m.uniform_ref[lx];
        mp[(lx * cells + k) * 2] = m.uniform_mv[lx][0];
        mp[(lx * cells + k) * 2 + 1] = m.uniform_mv[lx][1];
      }
  } else if (corners) {
    for (int lx = 0; lx < 2; lx++)
      for (int k = 0; k < 4; k++) {
        int src = kCorner[k];
        rp[lx * 4 + k] = m.ref4[lx][src];
        mp[(lx * 4 + k) * 2] = m.mv4[lx][src][0];
        mp[(lx * 4 + k) * 2 + 1] = m.mv4[lx][src][1];
      }
  } else {
    memcpy(rp, m.ref4, sizeof(m.ref4));
    memcpy(mp, m.mv4, sizeof(m.mv4));
  }
}

void EntropyDecoder::snap_mb(const MbCtx* cur) {
  size_t i = (size_t)(cur - mbs_.data());
  if (i >= snap_pic_.inter_ok.size()) return;
  // Slices of one picture must agree on frame/field/MBAFF structure
  // (7.4.3); a malformed stream can toggle field_pic or MBAFF
  // mid-picture, leaving the armed snapshot's layout stale (e.g. an
  // unsized field map) — skip the snapshot rather than write OOB.
  if (mbaff_ != snap_pic_.mbaff) return;
  const MbCtx& m = *cur;
  if (mbaff_) snap_pic_.field[i] = m.field_flag;
  bool ok = !m.intra && (size_t)m.slice_id < slice_list_pocs_.size();
  snap_pic_.inter_ok[i] = ok;
  if (!ok) return;
  snap_pic_.slice_id[i] = m.slice_id;
  snap_mb_into(m, i, &snap_pic_, snap_pic_.cells, snap_pic_.cells == 4);
}

void EntropyDecoder::store_ref_picture() {
  bool use_snap = snap_armed_;
  snap_armed_ = false;
  if (!dpb_valid_ || !cur_is_ref_) return;
  RefPic pic;
  if (!dpb_pool_.empty()) {
    pic = std::move(dpb_pool_.back());
    dpb_pool_.pop_back();
  }
  pic.frame_num = sh_.frame_num;
  pic.poc = cur_poc_;
  pic.poc_bot = cur_poc_bot_;
  pic.parity = field_pic_ ? (bottom_field_ ? 2 : 1) : 0;
  pic.mb_w = mb_w_;
  pic.mbaff = mbaff_;
  pic.lists = slice_list_pocs_;
  // Compact copy-out (NOT a buffer swap: swapping mbs_ into the DPB
  // was measured ~10% slower end-to-end — rotating the working array
  // through pooled buffers evicts it from cache every ref picture,
  // which costs more than this linear projection). Under
  // direct_8x8_inference only the four corner cells of each MB are
  // ever read back (col_cell's 8.4.1.2.2 mapping), so the snapshot is
  // 40 bytes/MB instead of 160.
  // Field pictures snapshot the FIELD grid (mb_w_ x mb_h_/2, field
  // raster — no frame-grid duplication; src_index is export-only).
  size_t n = (size_t)mb_w_ * pic_mb_rows_;
  // MBAFF pictures snapshot in ADDRESS order with full cell grids: the
  // colocated mapping (col_motion_mf) picks members and rows by pair
  // coding, so the corners-only projection does not apply. Field
  // pictures keep the full grid too (see the snap arming note).
  bool corners =
      active_sps_->direct_8x8_inference && !mbaff_ && !field_pic_;
  int cells = corners ? 4 : 16;
  pic.cells = cells;
  if (use_snap && snap_pic_.inter_ok.size() == n &&
      snap_pic_.cells == cells) {
    // The inline snapshot filled the pending RefPic at MB-decode time
    // (snap_mb) — steal its arrays; the pool arrays swapped back into
    // snap_pic_ get resized at the next arming.
    std::swap(pic.ref4, snap_pic_.ref4);
    std::swap(pic.mv4, snap_pic_.mv4);
    std::swap(pic.slice_id, snap_pic_.slice_id);
    std::swap(pic.inter_ok, snap_pic_.inter_ok);
    std::swap(pic.field, snap_pic_.field);
  } else {
    // Fallback: post-hoc walk of the MB array (kept for the snapshot
    // being unarmed or mis-sized; functionally identical).
    pic.ref4.resize(n * 2 * cells);
    pic.mv4.resize(n * 4 * cells);
    pic.slice_id.resize(n);
    pic.inter_ok.resize(n);
    pic.field.assign(mbaff_ ? n : 0, 0);
    for (size_t i = 0; i < n; i++) {
      // Field pictures walk storage (field raster) directly: src_index
      // maps the duplicated frame-grid EXPORT, not the snapshot.
      const MbCtx& m = mbs_[field_pic_ ? i : src_index(i)];
      bool ok = m.gen == gen_ && m.decoded && !m.intra &&
                (size_t)m.slice_id < slice_list_pocs_.size();
      pic.inter_ok[i] = ok;
      if (mbaff_ && m.gen == gen_ && m.decoded) pic.field[i] = m.field_flag;
      if (!ok) continue;
      pic.slice_id[i] = m.slice_id;
      snap_mb_into(m, i, &pic, cells, corners);
    }
  }
  pic.longterm = 0;
  pic.lt_idx = 0;
  // IDR with long_term_reference_flag (8.2.5.1): the IDR itself is
  // stored long-term with LongTermFrameIdx 0. (The flag only parses on
  // IDR slices, so it doubles as the IDR indicator here.)
  if (sh_.longterm_reference) {
    pic.longterm = 1;
    max_lt_idx_ = 0;
    dpb_.push_back(std::move(pic));  // DPB was cleared at the IDR
    return;
  }
  // Adaptive marking (8.2.5.4): the MMCO ops replace the sliding
  // window. PicNum domain (8.2.4.1): FrameNumWrap for frames;
  // 2*FrameNumWrap + 1 (same parity) / 2*FrameNumWrap (opposite) for
  // fields — each op then marks a single FIELD. LongTermPicNum ==
  // LongTermFrameIdx for frames, 2*idx(+1) for fields.
  if (!sh_.mmco.empty()) {
    int max_frame_num = 1 << active_sps_->log2_max_frame_num;
    int cur_parity = field_pic_ ? (bottom_field_ ? 2 : 1) : 0;
    int cur_pic_num = field_pic_ ? 2 * sh_.frame_num + 1 : sh_.frame_num;
    auto fnw = [&](const RefPic& r) {
      return r.frame_num > sh_.frame_num ? r.frame_num - max_frame_num
                                         : r.frame_num;
    };
    auto pic_num_of = [&](const RefPic& r) {
      if (!field_pic_) return fnw(r);
      return 2 * fnw(r) + (r.parity == cur_parity ? 1 : 0);
    };
    auto lt_num_of = [&](const RefPic& r) {
      if (!field_pic_) return r.lt_idx;
      return 2 * r.lt_idx + (r.parity == cur_parity ? 1 : 0);
    };
    // Unmark long-terms with LongTermFrameIdx == idx, sparing the
    // complementary field of (keep_fn, keep_parity) — 8.2.5.4.3/.6
    // keep the other field of the pair being (re)marked.
    auto drop_longterm = [&](int idx, int keep_fn, int keep_parity) {
      for (auto it = dpb_.begin(); it != dpb_.end();) {
        bool spare = keep_parity != 0 && it->parity != 0 &&
                     it->frame_num == keep_fn &&
                     it->parity != keep_parity;
        if (it->longterm && it->lt_idx == idx && !spare) {
          dpb_pool_.push_back(std::move(*it));
          it = dpb_.erase(it);
        } else {
          ++it;
        }
      }
    };
    for (const auto& op : sh_.mmco) {
      switch (op[0]) {
        case 1: {  // unmark a short-term picture/field (8.2.5.4.1)
          int pic_num_x = cur_pic_num - (op[1] + 1);
          for (auto it = dpb_.begin(); it != dpb_.end(); ++it)
            if (!it->longterm && pic_num_of(*it) == pic_num_x) {
              dpb_pool_.push_back(std::move(*it));
              dpb_.erase(it);
              break;
            }
          break;
        }
        case 2: {  // unmark a long-term picture/field (8.2.5.4.2)
          for (auto it = dpb_.begin(); it != dpb_.end(); ++it)
            if (it->longterm && lt_num_of(*it) == op[1]) {
              dpb_pool_.push_back(std::move(*it));
              dpb_.erase(it);
              break;
            }
          break;
        }
        case 3: {  // short-term -> long-term (8.2.5.4.3)
          int pic_num_x = cur_pic_num - (op[1] + 1);
          RefPic* target = nullptr;
          for (auto& r : dpb_)
            if (!r.longterm && pic_num_of(r) == pic_num_x) {
              target = &r;
              break;
            }
          drop_longterm(op[2], target ? target->frame_num : -1,
                        target ? target->parity : 0);
          if (target) {
            target->longterm = 1;
            target->lt_idx = op[2];
          }
          break;
        }
        case 4:  // MaxLongTermFrameIdx (8.2.5.4.4)
          max_lt_idx_ = op[1] - 1;
          for (auto it = dpb_.begin(); it != dpb_.end();) {
            if (it->longterm && it->lt_idx > max_lt_idx_) {
              dpb_pool_.push_back(std::move(*it));
              it = dpb_.erase(it);
            } else {
              ++it;
            }
          }
          break;
        case 5: {  // reset (8.2.5.4.5): unmark everything and treat the
          // current picture as frame_num 0. Deliberately mirrors
          // libavcodec (the reference's decoder is an FFmpeg fork)
          // rather than the strict spec: 8.2.5.4.5 also renormalizes
          // the resetting picture's POC to 0 and re-bases the
          // prevPicOrderCnt state, but libavcodec keeps both as coded
          // (verified empirically — a post-reset B's temporal-direct
          // scaling and colPic selection only match lavc's export_mvs
          // with the coded POCs; tools/dpb_gen.py scenario mmco5).
          // Modeled for POC type 0 only; type 1/2 + MMCO 5 degrades
          // (lavc's FrameNumOffset handling there is unverified).
          while (!dpb_.empty()) {
            dpb_pool_.push_back(std::move(dpb_.front()));
            dpb_.pop_front();
          }
          max_lt_idx_ = -1;
          pic.frame_num = 0;
          if (active_sps_->pic_order_cnt_type != 0) dpb_valid_ = false;
          break;
        }
        case 6:  // current picture/field -> long-term (8.2.5.4.6)
          drop_longterm(op[1], pic.frame_num, pic.parity);
          pic.longterm = 1;
          pic.lt_idx = op[1];
          break;
        default:
          break;
      }
    }
    // Mixed-parity marking (one field of a pair long-term, the
    // complement still a short-term reference — a lone MMCO 3 on a
    // field does this): libavcodec's frame-granular model cannot
    // represent it and silently drops the short member, so there is no
    // oracle — degrade. Homogeneous pair conversions (both fields in
    // one marking list) stay modeled.
    if (field_pic_) {
      for (const auto& a : dpb_)
        if (a.longterm)
          for (const auto& b : dpb_)
            if (!b.longterm && b.parity != 0 &&
                b.frame_num == a.frame_num && b.parity != a.parity)
              dpb_valid_ = false;
    }
    dpb_.push_back(std::move(pic));
    return;
  }
  // Sliding window: drop the oldest in decode order. max_num_ref_frames
  // counts FRAMES (8.2.5.3) — a complementary field pair (adjacent in
  // decode order, same frame_num, opposite parity) occupies one slot.
  size_t cap = active_sps_->max_num_ref_frames > 0
                   ? (size_t)active_sps_->max_num_ref_frames
                   : 1;
  auto complement = [](const RefPic& a, const RefPic& b) {
    return a.parity + b.parity == 3 && a.frame_num == b.frame_num;
  };
  auto frame_units = [&]() {
    size_t cnt = 0;
    const RefPic* open_field = nullptr;  // unpaired leading field
    for (const auto& r : dpb_) {
      if (open_field && complement(*open_field, r)) {
        open_field = nullptr;  // second field of the counted frame
        continue;
      }
      cnt++;
      open_field = r.parity ? &r : nullptr;
    }
    return cnt;
  };
  // The second field of the frame whose first field is at the back
  // completes an already-counted frame — storing it never evicts.
  bool completes_pair =
      pic.parity && !dpb_.empty() && complement(dpb_.back(), pic);
  while (!completes_pair && frame_units() >= cap) {
    // Evict the oldest SHORT-TERM picture: long-term references are
    // exempt from the sliding window (8.2.5.3 unmarks the short-term
    // with smallest FrameNumWrap; the deque is decode-ordered, so the
    // front-most short-term is it). Long-terms can coexist with field
    // pictures (homogeneous long-term pairs are modeled); only
    // mixed-parity marking degrades dpb_valid_ (see above).
    size_t ev = 0;
    while (ev < dpb_.size() && dpb_[ev].longterm) ev++;
    if (ev >= dpb_.size()) break;  // non-conforming: all slots long-term
    bool front_pair = dpb_.size() >= ev + 2 && dpb_[ev].parity &&
                      complement(dpb_[ev], dpb_[ev + 1]);
    dpb_pool_.push_back(std::move(dpb_[ev]));
    dpb_.erase(dpb_.begin() + ev);
    if (front_pair) {
      dpb_pool_.push_back(std::move(dpb_[ev]));
      dpb_.erase(dpb_.begin() + ev);
    }
  }
  dpb_.push_back(std::move(pic));
}

RefCell EntropyDecoder::col_cell(int cx, int cy, bool* ok) const {
  *ok = false;
  if (l1_.empty()) return RefCell();
  // An MBAFF-coded colocated picture stores MBs in address order with
  // pair-coding-dependent row mapping — only the MBAFF path
  // (col_motion_mf) reads those; a PROGRESSIVE B slice referencing one
  // (mixed-coding stream) degrades to plain spatial prediction. A
  // B FIELD over a FIELD colocated picture is the geometric identity
  // (8.4.1.2.2: colPic = RefPicList1[0], same half-height grid, same
  // address, MVs in field units on both sides — either parity); only
  // the frame/field MIXED cases degrade.
  if (l1_[0]->mbaff || (l1_[0]->parity != 0) != field_pic_)
    return RefCell();
  int w4 = 4 * mb_w_, h4 = 4 * pic_mb_rows_;
  if (cx < 0 || cy < 0 || cx >= w4 || cy >= h4) return RefCell();
  // The colocated snapshot's grid can be SMALLER than the current
  // picture's (mid-stream SPS geometry change without an IDR — only
  // mutated/non-conforming streams do this): degrade rather than read
  // out of the snapshot arrays (found by the PAFF corpus fuzzer).
  if (l1_[0]->mb_w != mb_w_ ||
      l1_[0]->inter_ok.size() < (size_t)mb_w_ * pic_mb_rows_)
    return RefCell();
  if (active_sps_->direct_8x8_inference) {
    // 8.4.1.2.2: each 8x8 uses its corner 4x4 of the colocated MB.
    cx = (cx & ~3) + 3 * ((cx >> 1) & 1);
    cy = (cy & ~3) + 3 * ((cy >> 1) & 1);
  } else if (l1_[0]->cells == 4) {
    // The colocated picture was snapshotted corners-only under a
    // direct_8x8_inference SPS but the current slice's SPS cleared the
    // flag (mid-stream SPS flip, no offline encoder emits this):
    // degrade to plain spatial prediction like the other unsupported
    // DPB markings rather than reading wrong cells.
    return RefCell();
  }
  *ok = true;
  return l1_[0]->cell(cx, cy);
}

// Spatial direct ref selection + median MVs over the whole MB
// (8.4.1.2.2): ref per list = MinPositive over neighbors A/B/C; both
// negative -> directZeroPrediction (both refs 0, zero mv).
void EntropyDecoder::spatial_direct_refs_mvs(int mb_x, int mb_y, int* ref_out,
                                             int16_t mv_out[2][2]) {
  int x0 = mb_x * 4, y0 = mb_y * 4;
  // The 8.4.1.3.2 neighbors used for ref selection are the SAME cells
  // median_pred would refetch for the 16x16 median (A=(x0-1,y0),
  // B=(x0,y0-1), C=(x0+4,y0-1), D fallback) — so fetch each neighbor
  // once for BOTH lists and compute ref + median inline. This halves
  // the neighbor lookups on the hottest decode path (B_Skip/B_Direct:
  // ~8M calls on the demo clip, 2 x 7 cell() each before the fusion).
  struct Nb {
    bool avail = false;
    bool intra = false;
    int8_t ref[2] = {-1, -1};
    int16_t mv[2][2] = {{0, 0}, {0, 0}};
  };
  Nb nb[3];
  auto fetch = [&](int cx, int cy, Nb& n) {
    if (cx < 0 || cy < 0) return;  // high side is bounds-checked by mb_at
    MbCtx* m = avail(cx >> 2, cy >> 2);
    if (!m) return;
    n.avail = true;
    n.intra = m->intra;
    if (m->uniform) {
      for (int lx = 0; lx < 2; lx++) {
        n.ref[lx] = m->uniform_ref[lx];
        n.mv[lx][0] = m->uniform_mv[lx][0];
        n.mv[lx][1] = m->uniform_mv[lx][1];
      }
      return;
    }
    int idx = (cy & 3) * 4 + (cx & 3);
    for (int lx = 0; lx < 2; lx++) {
      n.ref[lx] = m->ref4[lx][idx];
      n.mv[lx][0] = m->mv4[lx][idx][0];
      n.mv[lx][1] = m->mv4[lx][idx][1];
    }
  };
  fetch(x0 - 1, y0, nb[0]);      // A
  fetch(x0, y0 - 1, nb[1]);      // B
  fetch(x0 + 4, y0 - 1, nb[2]);  // C
  bool b_avail = nb[1].avail;
  if (!nb[2].avail) fetch(x0 - 1, y0 - 1, nb[2]);  // D fallback
  bool c_avail = nb[2].avail;

  for (int list = 0; list < 2; list++) {
    auto uses = [&](const Nb& n) {
      return n.avail && !n.intra && n.ref[list] >= 0;
    };
    int ref = -1;
    for (const Nb& n : nb)
      if (uses(n)) ref = ref < 0 ? n.ref[list] : std::min(ref, (int)n.ref[list]);
    ref_out[list] = ref;
    mv_out[list][0] = mv_out[list][1] = 0;
    if (ref < 0) continue;
    // Inline 8.4.1.3.1 median, bit-identical to median_pred(part_kind=0).
    auto match = [&](const Nb& n) { return uses(n) && n.ref[list] == ref; };
    if (!b_avail && !c_avail && nb[0].avail) {
      if (uses(nb[0])) {
        mv_out[list][0] = nb[0].mv[list][0];
        mv_out[list][1] = nb[0].mv[list][1];
      }
      continue;
    }
    int m = match(nb[0]) + match(nb[1]) + match(nb[2]);
    if (m == 1) {
      const Nb& r = match(nb[0]) ? nb[0] : (match(nb[1]) ? nb[1] : nb[2]);
      mv_out[list][0] = r.mv[list][0];
      mv_out[list][1] = r.mv[list][1];
      continue;
    }
    int16_t ma[2] = {uses(nb[0]) ? nb[0].mv[list][0] : (int16_t)0,
                     uses(nb[0]) ? nb[0].mv[list][1] : (int16_t)0};
    int16_t mb[2] = {uses(nb[1]) ? nb[1].mv[list][0] : (int16_t)0,
                     uses(nb[1]) ? nb[1].mv[list][1] : (int16_t)0};
    int16_t mc[2] = {uses(nb[2]) ? nb[2].mv[list][0] : (int16_t)0,
                     uses(nb[2]) ? nb[2].mv[list][1] : (int16_t)0};
    median3(ma, mb, mc, mv_out[list]);
  }
  if (ref_out[0] < 0 && ref_out[1] < 0) {
    // directZeroPredictionFlag
    ref_out[0] = ref_out[1] = 0;
    mv_out[0][0] = mv_out[0][1] = mv_out[1][0] = mv_out[1][1] = 0;
  }
}

void EntropyDecoder::derive_direct(MbCtx* cur, int mb_x, int mb_y, int x0,
                                   int y0, int w, int h) {
  // (progressive path; MBAFF macroblocks go through derive_direct_mf.)
  // A mixed-coding stream can put an MBAFF-coded picture in list1[0] —
  // its address-order snapshot is unreadable here, so degrade to plain
  // spatial prediction like an unavailable DPB. Same for frame/field
  // colocated mixes; a field col under a field B slice is supported
  // (see col_cell).
  bool have_col = dpb_valid_ && !l1_.empty() && !l1_[0]->mbaff &&
                  (l1_[0]->parity != 0) == field_pic_;
  bool temporal = sh_.type == SLICE_B && !sh_.direct_spatial_mv_pred &&
                  have_col;
  // colZeroFlag additionally requires RefPicList1[0] to be a
  // SHORT-term reference picture (8.4.1.2.2).
  bool col_short = have_col && !l1_[0]->longterm;
  // With direct_8x8_inference every cell of an 8x8 shares the corner
  // colocated cell (8.4.1.2.2) — derive per 8x8 group, not per cell
  // (B-heavy streams hit this for most macroblocks).
  int step = active_sps_->direct_8x8_inference ? 2 : 1;

  int sref[2] = {0, 0};
  int16_t smv[2][2] = {{0, 0}, {0, 0}};
  if (!temporal) {
    // Fast path: all three spatial-direct neighbors uniformly zero
    // (see MbCtx::uniform_zero) — the derivation result is exactly
    // {ref 0/0, mv 0}, which sref/smv already hold.
    MbCtx* na = nba_;
    MbCtx* nb = nbb_;
    MbCtx* ncr = avail(mb_x + 1, mb_y - 1);
    bool fast_zero = na && nb && ncr && na->uniform_zero &&
                     nb->uniform_zero && ncr->uniform_zero;
    if (!fast_zero) spatial_direct_refs_mvs(mb_x, mb_y, sref, smv);
    // colZero zeroes the mv of ref-0 lists per 8x8; when both lists'
    // spatial mvs are already zero (static regions — the common case)
    // it cannot change anything, so skip the colocated lookups and
    // write the whole part uniformly.
    bool need_colzero =
        col_short && sh_.direct_spatial_mv_pred &&
        ((sref[0] == 0 && (smv[0][0] | smv[0][1])) ||
         (sref[1] == 0 && (smv[1][0] | smv[1][1])));
    if (!need_colzero) {
      if (x0 == 0 && y0 == 0 && w == 4 && h == 4) {
        // Whole-MB uniform fill (the dominant case: B_Skip /
        // B_Direct_16x16): recorded in the header only — no
        // ref4/mv4/mvd4 writes; every reader honors MbCtx::uniform.
        cur->uniform = 1;
        for (int lx = 0; lx < 2; lx++) {
          cur->uniform_ref[lx] = (int8_t)sref[lx];
          cur->uniform_mv[lx][0] = sref[lx] < 0 ? 0 : smv[lx][0];
          cur->uniform_mv[lx][1] = sref[lx] < 0 ? 0 : smv[lx][1];
        }
        cur->uniform_zero =
            sref[0] == 0 && sref[1] == 0 &&
            !(smv[0][0] | smv[0][1] | smv[1][0] | smv[1][1]);
      } else {
        for (int yy = 0; yy < h; yy++)
          for (int xx = 0; xx < w; xx++) {
            int ci = (y0 + yy) * 4 + x0 + xx;
            for (int lx = 0; lx < 2; lx++) {
              if (sref[lx] < 0) {
                cur->ref4[lx][ci] = -1;
                continue;
              }
              cur->ref4[lx][ci] = (int8_t)sref[lx];
              cur->mv4[lx][ci][0] = smv[lx][0];
              cur->mv4[lx][ci][1] = smv[lx][1];
              cur->mvd4[lx][ci][0] = cur->mvd4[lx][ci][1] = 0;
            }
          }
      }
      for (int lx = 0; lx < 2; lx++)
        if (sref[lx] >= 0) {
          cur->mv_sum[0] += w * h * std::abs((int)smv[lx][0]);
          cur->mv_sum[1] += w * h * std::abs((int)smv[lx][1]);
          cur->mv_ssum[0] += w * h * (int)smv[lx][0];
          cur->mv_ssum[1] += w * h * (int)smv[lx][1];
          cur->mv_cells += (uint8_t)(w * h);
        }
      return;
    }
  }

  int32_t poc1 = temporal ? l1_[0]->poc : 0;
  for (int gy = 0; gy < h; gy += step)
    for (int gx = 0; gx < w; gx += step) {
      int cx = mb_x * 4 + x0 + gx, cy = mb_y * 4 + y0 + gy;
      int gh = std::min(step, h - gy), gw = std::min(step, w - gx);

      if (temporal) {
        // --- temporal direct (8.4.1.2.3) ---
        bool cok;
        RefCell cc = col_cell(cx, cy, &cok);
        int16_t mvcol[2] = {0, 0};
        int ref0 = 0;
        int32_t poc0 = l0_.empty() ? cur_poc_ : l0_[0]->poc;
        if (cok) {
          int cl = cc.poc[0] != kNoRefPoc ? 0
                   : (cc.poc[1] != kNoRefPoc ? 1 : -1);
          if (cl >= 0) {
            mvcol[0] = cc.mv[cl][0];
            mvcol[1] = cc.mv[cl][1];
            for (size_t i = 0; i < l0_.size(); i++)
              if (l0_[i]->poc == cc.poc[cl]) {
                ref0 = (int)i;
                poc0 = l0_[i]->poc;
                break;
              }
          }
        }
        int16_t mv0[2], mv1[2];
        if (trace_level() >= 3)
          fprintf(stderr,
                  "TD mb(%d,%d) grp(%d,%d) colpoc=%d mvcol=(%d,%d) ref0=%d "
                  "poc0=%d poc1=%d cur=%d\n",
                  mb_x, mb_y, gx, gy,
                  cok ? (cc.poc[0] != kNoRefPoc ? cc.poc[0] : cc.poc[1])
                      : -999,
                  mvcol[0], mvcol[1], ref0, poc0, poc1, cur_poc_);
        int td = std::max(-128, std::min(127, (int)(poc1 - poc0)));
        // 8.4.1.2.3: when the mapped L0 reference is LONG-TERM (or the
        // POC distance is zero) the colocated MV is used unscaled and
        // mvL1 is zero.
        bool lt_ref = (size_t)ref0 < l0_.size() && l0_[ref0]->longterm;
        if (td == 0 || lt_ref) {
          mv0[0] = mvcol[0];
          mv0[1] = mvcol[1];
          mv1[0] = mv1[1] = 0;
        } else {
          int tb = std::max(-128, std::min(127, (int)(cur_poc_ - poc0)));
          int tx = (16384 + std::abs(td) / 2) / td;
          int dsf = std::max(-1024, std::min(1023, (tb * tx + 32) >> 6));
          for (int k = 0; k < 2; k++) {
            mv0[k] = (int16_t)((dsf * mvcol[k] + 128) >> 8);
            mv1[k] = (int16_t)(mv0[k] - mvcol[k]);
          }
        }
        for (int yy = 0; yy < gh; yy++)
          for (int xx = 0; xx < gw; xx++) {
            int ci = (y0 + gy + yy) * 4 + x0 + gx + xx;
            cur->ref4[0][ci] = (int8_t)ref0;
            cur->mv4[0][ci][0] = mv0[0];
            cur->mv4[0][ci][1] = mv0[1];
            cur->ref4[1][ci] = 0;
            cur->mv4[1][ci][0] = mv1[0];
            cur->mv4[1][ci][1] = mv1[1];
            for (int lx = 0; lx < 2; lx++)
              cur->mvd4[lx][ci][0] = cur->mvd4[lx][ci][1] = 0;
          }
        cur->mv_sum[0] += gh * gw * (std::abs((int)mv0[0]) + std::abs((int)mv1[0]));
        cur->mv_sum[1] += gh * gw * (std::abs((int)mv0[1]) + std::abs((int)mv1[1]));
        cur->mv_ssum[0] += gh * gw * ((int)mv0[0] + (int)mv1[0]);
        cur->mv_ssum[1] += gh * gw * ((int)mv0[1] + (int)mv1[1]);
        cur->mv_cells += (uint8_t)(2 * gh * gw);
        continue;
      }

      // --- spatial direct (8.4.1.2.2) + colZero when DPB valid ---
      bool col_zero = false;
      if (col_short && sh_.direct_spatial_mv_pred &&
          (sref[0] == 0 || sref[1] == 0)) {
        bool cok;
        RefCell cc = col_cell(cx, cy, &cok);
        if (cok) {
          int cl = cc.poc[0] != kNoRefPoc ? 0
                   : (cc.poc[1] != kNoRefPoc ? 1 : -1);
          col_zero = cl >= 0 && cc.refidx[cl] == 0 &&
                     cc.mv[cl][0] >= -1 && cc.mv[cl][0] <= 1 &&
                     cc.mv[cl][1] >= -1 && cc.mv[cl][1] <= 1;
        }
      }
      for (int yy = 0; yy < gh; yy++)
        for (int xx = 0; xx < gw; xx++) {
          int ci = (y0 + gy + yy) * 4 + x0 + gx + xx;
          for (int lx = 0; lx < 2; lx++) {
            if (sref[lx] < 0) {
              cur->ref4[lx][ci] = -1;
              continue;
            }
            bool zero = col_zero && sref[lx] == 0;
            cur->ref4[lx][ci] = (int8_t)sref[lx];
            cur->mv4[lx][ci][0] = zero ? 0 : smv[lx][0];
            cur->mv4[lx][ci][1] = zero ? 0 : smv[lx][1];
            cur->mvd4[lx][ci][0] = cur->mvd4[lx][ci][1] = 0;
          }
        }
      for (int lx = 0; lx < 2; lx++)
        if (sref[lx] >= 0) {
          bool zero = col_zero && sref[lx] == 0;
          if (!zero) {
            cur->mv_sum[0] += gh * gw * std::abs((int)smv[lx][0]);
            cur->mv_sum[1] += gh * gw * std::abs((int)smv[lx][1]);
            cur->mv_ssum[0] += gh * gw * (int)smv[lx][0];
            cur->mv_ssum[1] += gh * gw * (int)smv[lx][1];
          }
          cur->mv_cells += (uint8_t)(gh * gw);
        }
    }
}

// ---------------------------------------------------------------------------
// Slice + macroblock layer
// ---------------------------------------------------------------------------

int EntropyDecoder::decode_slice(const uint8_t* rbsp, size_t size,
                                 int nal_type, int nal_ref_idc) {
  BitReader br(rbsp, size);
  const Sps* sps = nullptr;
  const Pps* pps = nullptr;
  if (!parse_slice_header(br, nal_type, nal_ref_idc, spss_, ppss_, &sps, &pps,
                          &sh_))
    return -2;
  // Interlace: MBAFF frames decode through the dedicated path in
  // entdec_mbaff.cc; plain frame pictures of a PAFF-capable stream
  // (frame_mbs_only=0, field_pic_flag=0, no MBAFF) parse exactly like
  // progressive ones. PAFF field pictures decode through the
  // progressive machinery at half height: one field = one picture of
  // mb_w_ x (mb_h_/2) macroblocks with field residual contexts
  // (resid_field_), field POC (compute_poc) and field reference lists
  // (build_ref_lists). Validated against libavcodec on hand-written
  // conforming field streams (tools/paff_gen.py — x264 cannot emit
  // PAFF, so the validation corpus is first-party).
  // separate_colour_plane (High 4:4:4, 7.4.2.1.1): each plane parses
  // through the progressive machinery as a monochrome picture at its
  // own MB-array offset (plane_off_). Interlaced separate-plane
  // streams decode too — the plane routing is per-slice and the PAFF
  // field machinery (field POC, field lists, resid_field_) is
  // picture-level, so they compose; validated against monochrome PAFF
  // twins (tools/sep_gen.py field scenarios). MBAFF FRAME pictures of
  // a separate-plane stream (the last typed rejection through early
  // round 4) decode as well: the MBAFF pair path routes through
  // plane_off_ like the progressive one, validated against monochrome
  // MBAFF twins (sep_gen mbaff scenarios) — no conforming stream
  // shape is rejected.
  active_sps_ = sps;
  active_pps_ = pps;
  field_pic_ = sh_.field_pic;
  bottom_field_ = sh_.bottom_field;
  // mb_field_decoding_flag syntax (MBAFF pair loop) only applies to
  // FRAME pictures of an MBAFF-capable stream; its field pictures are
  // plain PAFF fields (7.4.4).
  mbaff_ = !sps->frame_mbs_only && sps->mb_adaptive_frame_field &&
           !sh_.field_pic;

  if (!picture_started_) {
    start_picture(*sps);
    compute_poc(nal_type, nal_ref_idc);
    // Arm the inline DPB snapshot (snap_mb) for reference pictures:
    // the pending RefPic's buffers are recycled from the pool via the
    // array swap in store_ref_picture.
    snap_armed_ = dpb_valid_ && cur_is_ref_;
    if (snap_armed_) {
      size_t n = (size_t)mb_w_ * pic_mb_rows_;
      // Field pictures snapshot the full cell grid: the colocated
      // lookup for a field reference (col_cell_field) maps frame rows
      // to field rows geometrically, outside the corners-only contract.
      bool corners =
          active_sps_->direct_8x8_inference && !mbaff_ && !field_pic_;
      snap_pic_.cells = corners ? 4 : 16;
      snap_pic_.mb_w = mb_w_;
      snap_pic_.mbaff = mbaff_;
      snap_pic_.ref4.resize(n * 2 * snap_pic_.cells);
      snap_pic_.mv4.resize(n * 4 * snap_pic_.cells);
      snap_pic_.slice_id.resize(n);
      snap_pic_.inter_ok.assign(n, 0);
      snap_pic_.field.assign(mbaff_ ? n : 0, 0);
    }
  }
  // Route this slice's macroblocks to its colour plane's MB region
  // (plane 0 for everything but Cb/Cr slices of a separate-plane
  // stream). Needs mb_w_/mb_h_, i.e. start_picture above.
  plane_off_ = sps->separate_colour_plane
                   ? (size_t)sh_.colour_plane_id * mb_w_ * mb_h_
                   : 0;
  build_ref_lists();

  if (!pps->entropy_coding_mode) {
    if (mbaff_) return decode_slice_mbaff_cavlc(br);
    return decode_slice_cavlc(br, nal_type, nal_ref_idc);
  }

  // cabac_alignment_one_bit
  size_t bitpos = br.bit_pos();
  bitpos = (bitpos + 7) & ~(size_t)7;
  cabac_.init_contexts(sh_.type == SLICE_I || sh_.type == SLICE_SI,
                       sh_.cabac_init_idc, sh_.slice_qp);
  cabac_.init_engine(rbsp, size, bitpos);
  cabac_.trace_fn = trace_level() >= 2 ? &trace_bin : nullptr;
  last_qp_delta_ = 0;
  // PAFF field pictures use the field residual context rows
  // (Table 9-34/9-43), exactly like MBAFF field macroblocks.
  resid_field_ = field_pic_;
  trace_qp_ = sh_.slice_qp;
  if (trace_enabled())
    fprintf(stderr, "slice: type=%d qp=%d first_mb=%d cabac_init=%d nref=%d/%d bitpos=%zu\n",
            sh_.type, sh_.slice_qp, sh_.first_mb_in_slice, sh_.cabac_init_idc,
            sh_.num_ref_idx_l0, sh_.num_ref_idx_l1, bitpos);
  if (mbaff_) return decode_slice_mbaff_cabac();

  bool b_slice = sh_.type == SLICE_B;
  bool p_slice = sh_.type == SLICE_P;
  bool i_slice = !b_slice && !p_slice;

  int mb_addr = sh_.first_mb_in_slice;
  int total = mb_w_ * pic_mb_rows_;
  // Incremental raster coords: the per-MB %, / pair is a runtime idiv
  // (mb_w_ is not a compile-time constant) on the hottest loop.
  int mb_x = mb_addr % mb_w_;
  int mb_y = mb_addr / mb_w_;
  while (mb_addr < total) {
    MbCtx* cur = &mbs_[plane_off_ + mb_addr];
    cur->reset(gen_, slice_id_, /*zero_nnz=*/false);
    nba_ = avail(mb_x - 1, mb_y);
    nbb_ = avail(mb_x, mb_y - 1);

    bool skipped = false;
    if (!i_slice) skipped = cabac_mb_skip(mb_x, mb_y, b_slice);

    if (skipped) {
      process_skip_mb(cur, mb_x, mb_y, p_slice);
      last_qp_delta_ = 0;
      if (cabac_.overrun()) return -6;
      if (cabac_.terminate()) break;
      mb_addr++;
      if (++mb_x == mb_w_) { mb_x = 0; mb_y++; }
      continue;
    }

    // ---- mb_type ----
    int intra_code = -1;  // 0 I_NxN, 1..24 I16, 25 PCM
    int p_type = -1, b_type = -1;
    if (i_slice) {
      intra_code = cabac_mb_type_i(3, true, mb_x, mb_y);
    } else if (p_slice) {
      p_type = cabac_mb_type_p();
      if (p_type >= 5) intra_code = p_type - 5;
    } else {
      b_type = cabac_mb_type_b(mb_x, mb_y);
      if (b_type >= 23) intra_code = b_type - 23;
    }

    cur->decoded = 1;
    if (intra_code == 25) {
      // I_PCM (7.3.5): raw samples start at the byte boundary after the
      // encoder's terminate flush (see CabacDecoder::pcm_data_pos); they
      // are skipped (entropy-only decode needs no pixels) and the engine
      // re-initializes at the following byte (9.3.1.2) with context
      // variables preserved.
      cabac_.reinit_at(cabac_.pcm_data_pos() + pcm_sample_bits());
      mark_pcm(cur);
      last_qp_delta_ = 0;
      if (trace_enabled())
        fprintf(stderr, "mb %d (%d,%d) pcm bitpos=%zu\n", mb_addr, mb_x,
                mb_y, cabac_.bit_pos());
      if (cabac_.overrun()) return -6;
      if (cabac_.terminate()) break;
      mb_addr++;
      if (++mb_x == mb_w_) { mb_x = 0; mb_y++; }
      continue;
    }

    int cbp_luma = 0, cbp_chroma = 0;
    bool intra = intra_code >= 0;
    cur->intra = intra;

    PartList parts;

    int cfi = chroma_array_type();
    if (intra) {
      cur->mb_class = MB_INTRA;
      if (intra_code == 0) {
        cur->intra_nxn = 1;
        if (active_pps_->transform_8x8_mode)
          cur->t8x8 = cabac_transform_8x8(mb_x, mb_y);
        int n = cur->t8x8 ? 4 : 16;
        // 4:4:4 (ChromaArrayType 3): Cb/Cr REUSE the luma intra modes —
        // no extra pred-mode syntax and no intra_chroma_pred_mode
        // (7.3.5.1, 8.3.4).
        for (int i = 0; i < n; i++) {
          if (!cabac_.decision(68)) {
            cabac_.decision(69);
            cabac_.decision(69);
            cabac_.decision(69);
          }
        }
        if (cfi == 1 || cfi == 2)
          cur->chroma_mode = cabac_intra_chroma_mode(mb_x, mb_y);
      } else {
        cur->i16 = 1;
        int v = intra_code - 1;
        cbp_chroma = (v / 4) % 3;
        cbp_luma = (v >= 12) ? 0xf : 0;
        if (cfi == 1 || cfi == 2)
          cur->chroma_mode = cabac_intra_chroma_mode(mb_x, mb_y);
      }
    } else if (p_slice) {
      int sub[4] = {0, 0, 0, 0};
      if (p_type == 3)
        for (int i = 0; i < 4; i++) sub[i] = cabac_sub_mb_type_p();
      build_parts_p(p_type, sub, cur, parts);
    } else {
      int sub[4] = {0, 0, 0, 0};
      if (b_type == 22)
        for (int i = 0; i < 4; i++) sub[i] = cabac_sub_mb_type_b();
      build_parts_b(b_type, sub, cur, parts);
    }

    // ---- inter prediction syntax: refs then mvds (7.3.5.1 / 7.3.5.2) ----
    if (!intra && !parts.empty()) {
      // ref_idx per partition per list. For 8x8 modes refs are per 8x8
      // block (first part of each 8x8 carries it); we approximate by
      // assigning to every part of the 8x8 the same decoded ref, reading
      // one ref per 8x8 in order — achieved by reading refs for parts
      // whose (x0,y0) is the 8x8 origin and copying to siblings.
      for (int list = 0; list < 2; list++) {
        int lbit = 1 << list;
        int active_refs = list == 0 ? sh_.num_ref_idx_l0 : sh_.num_ref_idx_l1;
        int last_i8 = -1, last_ref = 0;
        for (auto& pp : parts) {
          if (pp.direct || !(pp.list_mask & lbit)) continue;
          int i8 = (pp.y0 >= 2 ? 2 : 0) + (pp.x0 >= 2 ? 1 : 0);
          bool is_sub = cur->mb_class == MB_INTER_8X8;
          int r;
          if (is_sub && i8 == last_i8) {
            r = last_ref;
          } else {
            r = 0;
            if (active_refs > 1)
              r = cabac_ref_idx(list, mb_x * 4 + pp.x0, mb_y * 4 + pp.y0);
            last_i8 = i8;
            last_ref = r;
          }
          pp.ref[list] = r;
          // Publish to the cell grid immediately: the ref_idx context of
          // later partitions (same MB included) reads refIdx > 0 flags of
          // already-decoded neighbors (9.3.3.1.1.6).
          for (int yy = 0; yy < pp.h; yy++)
            for (int xx = 0; xx < pp.w; xx++)
              cur->ref4[list][(pp.y0 + yy) * 4 + pp.x0 + xx] = (int8_t)r;
        }
      }
      for (int list = 0; list < 2; list++) {
        int lbit = 1 << list;
        for (auto& pp : parts) {
          if (pp.direct || !(pp.list_mask & lbit)) continue;
          int cx = mb_x * 4 + pp.x0, cy = mb_y * 4 + pp.y0;
          cabac_mvd_pair(list, cx, cy, pp.mvd[list]);
          // Record mvd at cell granularity immediately (later partitions'
          // mvd contexts read it).
          for (int yy = 0; yy < pp.h; yy++)
            for (int xx = 0; xx < pp.w; xx++) {
              int ci = (pp.y0 + yy) * 4 + pp.x0 + xx;
              cur->mvd4[list][ci][0] = (int16_t)pp.mvd[list][0];
              cur->mvd4[list][ci][1] = (int16_t)pp.mvd[list][1];
              cur->ref4[list][ci] = (int8_t)pp.ref[list];  // provisional
            }
        }
      }
    }

    // ---- coded_block_pattern / transform size ----
    bool sub8x8_ok = sub_parts_8x8_ok(parts, cur);
    if (!intra || cur->intra_nxn) {
      if (!cur->i16 && !cur->intra_nxn) {
        cbp_luma = cabac_cbp_luma(mb_x, mb_y);
        int full = cbp_luma;
        cbp_chroma = (cfi == 1 || cfi == 2)
                         ? cabac_cbp_chroma(mb_x, mb_y)
                         : 0;
        cur->cbp_luma = (uint8_t)full;
        cur->cbp_chroma = (uint8_t)cbp_chroma;
        if (full && active_pps_->transform_8x8_mode && !cur->intra_nxn &&
            sub8x8_ok &&
            (b_type != 0 || active_sps_->direct_8x8_inference)) {
          cur->t8x8 = cabac_transform_8x8(mb_x, mb_y);
        }
      } else if (cur->intra_nxn) {
        cbp_luma = cabac_cbp_luma(mb_x, mb_y);
        cbp_chroma = (cfi == 1 || cfi == 2)
                         ? cabac_cbp_chroma(mb_x, mb_y)
                         : 0;
        cur->cbp_luma = (uint8_t)cbp_luma;
        cur->cbp_chroma = (uint8_t)cbp_chroma;
      }
    }
    if (cur->i16) {
      if (cfi == 3) cbp_chroma = 0;  // CAT3: no CodedBlockPatternChroma
      cur->cbp_luma = (uint8_t)cbp_luma;
      cur->cbp_chroma = (uint8_t)cbp_chroma;
    }

    // ---- residual ----
    int nnz = 0;
    bool have_residual = cbp_luma || cbp_chroma || cur->i16;
    if (have_residual) {
      int dq = cabac_qp_delta();
      last_qp_delta_ = dq;
      if (trace_enabled()) fprintf(stderr, "  dq=%d\n", dq);
      trace_qp_ = ((trace_qp_ + dq + 52 + 2 * 0) % 52 + 52) % 52;  // 8-bit depth wrap
      // Luma-syntax planes: Y, plus Cb and Cr in 4:4:4 (7.3.5.3:
      // residual_luma runs per plane, gated by the SAME
      // CodedBlockPatternLuma; CABAC ctxBlockCats 6-13).
      int planes = cfi == 3 ? 3 : 1;
      for (int pl = 0; pl < planes; pl++) {
        int cat_dc = pl == 0 ? 0 : (pl == 1 ? 6 : 10);
        int cat_i16ac = pl == 0 ? 1 : (pl == 1 ? 7 : 11);
        int cat_4x4 = pl == 0 ? 2 : (pl == 1 ? 8 : 12);
        int cat_8x8 = pl == 0 ? 5 : (pl == 1 ? 9 : 13);
        if (cur->i16) {
          int cbf = 0;
          nnz += residual_block(cat_dc, 16,
                                cbf_ctx_luma_dc(mb_x, mb_y, pl), true, &cbf);
          if (cbf) cur->cbf_luma_dc |= 1u << pl;
        }
        for (int i8 = 0; i8 < 4; i8++) {
          if (!((cbp_luma >> i8) & 1)) continue;
          if (cur->t8x8) {
            // 8x8 blocks have coded_block_flag ONLY when
            // ChromaArrayType == 3 (7.4.5.3.3).
            int cbf = 0;
            bool has_cbf = cfi == 3;
            int inc =
                has_cbf ? cbf_ctx_luma8x8(mb_x, mb_y, i8, pl) : 0;
            int n8 = residual_block(cat_8x8, 64, inc, has_cbf, &cbf);
            nnz += n8;
            if (cbf) {
              for (int i4 = 0; i4 < 4; i4++) {
                int blk = blk_raster(i8, i4);
                cur->cbf_luma[pl] |= 1u << blk;
                // Approximate per-4x4 share (only consumed by CAVLC nC
                // of later pictures; streams rarely mix entropy modes).
                cur->nnz4[pl][blk] = (uint8_t)std::min(n8 / 4, 16);
              }
            }
          } else {
            for (int i4 = 0; i4 < 4; i4++) {
              int blk = blk_raster(i8, i4);
              int cbf = 0;
              int nb;
              if (cur->i16) {
                nb = residual_block(cat_i16ac, 15,
                                    cbf_ctx_luma4x4(mb_x, mb_y, blk, pl),
                                    true, &cbf);
              } else {
                nb = residual_block(cat_4x4, 16,
                                    cbf_ctx_luma4x4(mb_x, mb_y, blk, pl),
                                    true, &cbf);
              }
              nnz += nb;
              cur->nnz4[pl][blk] = (uint8_t)nb;
              if (cbf) cur->cbf_luma[pl] |= 1u << blk;
            }
          }
        }
      }
      // Chroma (4:2:0: 4-coeff DC + 4 AC blocks; 4:2:2: 8-coeff DC +
      // 8 AC blocks per component).
      if (cfi == 1 || cfi == 2) {
        if (cbp_chroma) {
          for (int comp = 0; comp < 2; comp++) {
            int cbf = 0;
            nnz += residual_block(3, ch_dc_coeffs(),
                                  cbf_ctx_chroma_dc(mb_x, mb_y, comp),
                                  true, &cbf);
            if (cbf) cur->cbf_chroma_dc |= 1u << comp;
          }
        }
        if (cbp_chroma == 2) {
          for (int comp = 0; comp < 2; comp++) {
            for (int blk = 0; blk < ch_ac_blocks(); blk++) {
              int cbf = 0;
              int nb = residual_block(
                  4, 15, cbf_ctx_chroma_ac(mb_x, mb_y, comp, blk), true, &cbf);
              nnz += nb;
              cur->nnzc[comp][blk] = (uint8_t)nb;
              if (cbf) cur->cbf_chroma_ac[comp] |= 1u << blk;
            }
          }
        }
      }
    } else {
      last_qp_delta_ = 0;
    }
    cur->nnz_total = (uint16_t)nnz;
    // ---- MV reconstruction for inter partitions (in decoding order) ----
    if (!intra) reconstruct_inter(cur, parts, mb_x, mb_y);

    if (trace_enabled()) {
      fprintf(stderr,
              "mb %d (%d,%d) intra=%d code(i/p/b)=%d/%d/%d t8=%d cbpL=%x "
              "cbpC=%d nnz=%d qp=%d bitpos=%zu\n",
              mb_addr, mb_x, mb_y, (int)cur->intra, intra_code, p_type, b_type,
              (int)cur->t8x8, cbp_luma, cbp_chroma, nnz, trace_qp_,
              cabac_.bit_pos());
    }
    finish_mb_output(cur);
    if (cabac_.overrun()) return -6;
    if (cabac_.terminate()) break;
    mb_addr++;
    if (++mb_x == mb_w_) { mb_x = 0; mb_y++; }
  }
  return cabac_.overrun() ? -6 : 0;
}


// ---------------------------------------------------------------------------
// Shared macroblock-layer helpers (CABAC + CAVLC)
// ---------------------------------------------------------------------------

// Bits of raw pcm_sample_luma + pcm_sample_chroma for one I_PCM MB
// (7.3.5: 256 luma samples + 2 * MbWidthC * MbHeightC chroma samples,
// each BitDepth bits; 4:2:0 has 8x8 chroma blocks).
size_t EntropyDecoder::pcm_sample_bits() const {
  size_t bits = 256u * (size_t)active_sps_->bit_depth_luma;
  // 2 * MbWidthC * MbHeightC chroma samples: 128 in 4:2:0, 256 in
  // 4:2:2, 512 in 4:4:4; none when ChromaArrayType is 0 (monochrome
  // or a separate-plane slice, whose I_PCM carries luma samples only).
  int cat = chroma_array_type();
  if (cat == 1)
    bits += 128u * (size_t)active_sps_->bit_depth_chroma;
  else if (cat == 2)
    bits += 256u * (size_t)active_sps_->bit_depth_chroma;
  else if (cat == 3)
    bits += 512u * (size_t)active_sps_->bit_depth_chroma;
  return bits;
}

// Neighbor-context fallout of an I_PCM MB: treated as intra with every
// coded_block_flag inferred 1 and total_coeff 16 per block (9.3.3.1.1,
// 9.2.1), mb_qp_delta absent.
void EntropyDecoder::mark_pcm(MbCtx* cur) {
  cur->pcm = 1;
  cur->intra = 1;
  cur->mb_class = MB_INTRA;
  cur->cbp_luma = 0xf;
  cur->cbp_chroma = 2;
  for (int pl = 0; pl < 3; pl++) cur->cbf_luma[pl] = 0xffff;
  cur->cbf_luma_dc = 7;
  cur->cbf_chroma_dc = 3;
  cur->cbf_chroma_ac[0] = cur->cbf_chroma_ac[1] = 0xff;
  for (int pl = 0; pl < 3; pl++)
    for (int i = 0; i < 16; i++) cur->nnz4[pl][i] = 16;
  for (int c = 0; c < 2; c++)
    for (int b = 0; b < 8; b++) cur->nnzc[c][b] = 16;
  // Metadata density channel: saturate (raw samples == max energy).
  cur->nnz_total = 384;
  cur->qp_delta_nonzero = 0;
  finish_mb_output(cur);
}

void EntropyDecoder::process_skip_mb(MbCtx* cur, int mb_x, int mb_y,
                                     bool p_slice) {
  cur->decoded = 1;
  cur->skip = 1;
  cur->mb_class = MB_SKIP;
  cur->direct_mask = 0xffff;
  int x0 = mb_x * 4, y0 = mb_y * 4;
  if (p_slice) {
    // P_Skip: ref0 with predicted MV (8.4.1.1).
    CellRef A = cell(0, x0 - 1, y0);
    CellRef B = cell(0, x0, y0 - 1);
    int16_t mv[2] = {0, 0};
    bool zero = !A.avail || !B.avail ||
                (!A.intra && A.ref == 0 && A.mv[0] == 0 && A.mv[1] == 0) ||
                (!B.intra && B.ref == 0 && B.mv[0] == 0 && B.mv[1] == 0);
    if (!zero) median_pred(0, 0, x0, y0, 4, 4, 0, mv);
    // Header-only uniform fill: ref0 everywhere on list 0, list 1
    // unused, zero mvd (see MbCtx::uniform).
    cur->uniform = 1;
    cur->uniform_ref[0] = 0;
    cur->uniform_ref[1] = -1;
    cur->uniform_mv[0][0] = mv[0];
    cur->uniform_mv[0][1] = mv[1];
    cur->uniform_mv[1][0] = cur->uniform_mv[1][1] = 0;
    cur->mv_sum[0] += 16 * std::abs((int)mv[0]);
    cur->mv_sum[1] += 16 * std::abs((int)mv[1]);
    cur->mv_ssum[0] += 16 * (int)mv[0];
    cur->mv_ssum[1] += 16 * (int)mv[1];
    cur->mv_cells += 16;
  } else {
    // B_Skip: full B-direct derivation (8.4.1.2) — temporal scaling or
    // spatial + colZero when the DPB is modeled, spatial otherwise.
    derive_direct(cur, mb_x, mb_y, 0, 0, 4, 4);
  }
  finish_mb_output(cur);
}

void EntropyDecoder::build_parts_p(int p_type, const int* sub, MbCtx* cur,
                                   PartList& parts) {
  switch (p_type) {
    case 0:
    case 4:  // P_8x8ref0 shares 16x16 geometry per sub; handled below
      if (p_type == 0) {
        cur->mb_class = MB_INTER_16X16;
        parts.push_back({1, 0, 0, 4, 4, 0});
        break;
      }
      [[fallthrough]];
    case 3: {
      cur->mb_class = MB_INTER_8X8;
      for (int i8 = 0; i8 < 4; i8++) {
        int bx = (i8 & 1) * 2, by = (i8 >> 1) * 2;
        switch (sub[i8]) {
          case 0:
            parts.push_back({1, bx, by, 2, 2, 0});
            break;
          case 1:  // 8x4
            parts.push_back({1, bx, by, 2, 1, 0});
            parts.push_back({1, bx, by + 1, 2, 1, 0});
            break;
          case 2:  // 4x8
            parts.push_back({1, bx, by, 1, 2, 0});
            parts.push_back({1, bx + 1, by, 1, 2, 0});
            break;
          default:  // 4x4
            for (int k = 0; k < 4; k++)
              parts.push_back({1, bx + (k & 1), by + (k >> 1), 1, 1, 0});
        }
      }
      break;
    }
    case 1:
      cur->mb_class = MB_INTER_RECT;
      parts.push_back({1, 0, 0, 4, 2, 1});
      parts.push_back({1, 0, 2, 4, 2, 2});
      break;
    case 2:
      cur->mb_class = MB_INTER_RECT;
      parts.push_back({1, 0, 0, 2, 4, 3});
      parts.push_back({1, 2, 0, 2, 4, 4});
      break;
  }
}

void EntropyDecoder::build_parts_b(int b_type, const int* sub, MbCtx* cur,
                                   PartList& parts) {
  if (b_type == 0) {
    cur->mb_class = MB_DIRECT;
    cur->is_direct16 = 1;
    cur->direct_mask = 0xffff;
    PendingPart d{3, 0, 0, 4, 4, 0};
    d.direct = true;
    parts.push_back(d);
  } else if (b_type <= 3) {
    cur->mb_class = MB_INTER_16X16;
    parts.push_back({b_type == 1 ? 1 : (b_type == 2 ? 2 : 3), 0, 0, 4, 4, 0});
  } else if (b_type <= 21) {
    cur->mb_class = MB_INTER_RECT;
    static const int masks[9][2] = {{1, 1}, {2, 2}, {1, 2}, {2, 1}, {1, 3},
                                    {2, 3}, {3, 1}, {3, 2}, {3, 3}};
    const int* mk = masks[(b_type - 4) / 2];
    bool horiz = ((b_type - 4) & 1) == 0;  // even: 16x8
    if (horiz) {
      parts.push_back({mk[0], 0, 0, 4, 2, 1});
      parts.push_back({mk[1], 0, 2, 4, 2, 2});
    } else {
      parts.push_back({mk[0], 0, 0, 2, 4, 3});
      parts.push_back({mk[1], 2, 0, 2, 4, 4});
    }
  } else {  // B_8x8
    cur->mb_class = MB_INTER_8X8;
    static const int smask[13] = {3, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3};
    for (int i8 = 0; i8 < 4; i8++) {
      int bx = (i8 & 1) * 2, by = (i8 >> 1) * 2;
      int sv = sub[i8];
      if (sv == 0) {
        PendingPart d{3, bx, by, 2, 2, 0};
        d.direct = true;
        parts.push_back(d);
        for (int k = 0; k < 4; k++) {
          int cx = bx + (k & 1), cy = by + (k >> 1);
          cur->direct_mask |= 1u << (cy * 4 + cx);
        }
        continue;
      }
      int mask = smask[sv];
      if (sv <= 3) {  // 8x8
        parts.push_back({mask, bx, by, 2, 2, 0});
      } else if (sv == 4 || sv == 6 || sv == 8) {  // 8x4
        parts.push_back({mask, bx, by, 2, 1, 0});
        parts.push_back({mask, bx, by + 1, 2, 1, 0});
      } else if (sv == 5 || sv == 7 || sv == 9) {  // 4x8
        parts.push_back({mask, bx, by, 1, 2, 0});
        parts.push_back({mask, bx + 1, by, 1, 2, 0});
      } else {  // 4x4
        for (int k = 0; k < 4; k++)
          parts.push_back({mask, bx + (k & 1), by + (k >> 1), 1, 1, 0});
      }
    }
  }
}

bool EntropyDecoder::sub_parts_8x8_ok(const PartList& parts,
                                      const MbCtx* cur) const {
  if (cur->mb_class != MB_INTER_8X8) return true;
  for (const auto& pp : parts) {
    if (pp.direct) {
      if (!active_sps_->direct_8x8_inference) return false;
    } else if (pp.w < 2 || pp.h < 2) {
      return false;
    }
  }
  return true;
}

void EntropyDecoder::reconstruct_inter(MbCtx* cur,
                                       PartList& parts,
                                       int mb_x, int mb_y) {
  for (auto& pp : parts) {
    int cx = mb_x * 4 + pp.x0, cy = mb_y * 4 + pp.y0;
    if (pp.direct) {
      // B-direct part (8.4.1.2): temporal or spatial(+colZero).
      derive_direct(cur, mb_x, mb_y, pp.x0, pp.y0, pp.w, pp.h);
      continue;
    }
    for (int list = 0; list < 2; list++) {
      if (!(pp.list_mask & (1 << list))) {
        for (int yy = 0; yy < pp.h; yy++)
          for (int xx = 0; xx < pp.w; xx++)
            cur->ref4[list][(pp.y0 + yy) * 4 + pp.x0 + xx] = -1;
        continue;
      }
      int16_t pred[2] = {0, 0};
      median_pred(list, pp.ref[list], cx, cy, pp.w, pp.h, pp.kind, pred);
      int16_t mvx = (int16_t)(pred[0] + pp.mvd[list][0]);
      int16_t mvy = (int16_t)(pred[1] + pp.mvd[list][1]);
      cur->mv_sum[0] += pp.w * pp.h * std::abs((int)mvx);
      cur->mv_sum[1] += pp.w * pp.h * std::abs((int)mvy);
      cur->mv_ssum[0] += pp.w * pp.h * (int)mvx;
      cur->mv_ssum[1] += pp.w * pp.h * (int)mvy;
      cur->mv_cells += (uint8_t)(pp.w * pp.h);
      if (trace_level() >= 3)
        fprintf(stderr,
                "EX mb(%d,%d) part(%d,%d %dx%d k%d) L%d ref=%d pred=(%d,%d) "
                "mvd=(%d,%d) -> (%d,%d)\n",
                mb_x, mb_y, pp.x0, pp.y0, pp.w, pp.h, pp.kind, list,
                pp.ref[list], pred[0], pred[1], pp.mvd[list][0],
                pp.mvd[list][1], mvx, mvy);
      for (int yy = 0; yy < pp.h; yy++)
        for (int xx = 0; xx < pp.w; xx++) {
          int ci = (pp.y0 + yy) * 4 + pp.x0 + xx;
          cur->ref4[list][ci] = (int8_t)pp.ref[list];
          cur->mv4[list][ci][0] = mvx;
          cur->mv4[list][ci][1] = mvy;
        }
    }
  }
}


// ---------------------------------------------------------------------------
// CAVLC (9.2) — Baseline/Extended-profile entropy coding
// ---------------------------------------------------------------------------

namespace {

// Two-level lookup tables for every CAVLC VLC (built once at load from
// the normative (len, bits) tables) — replaces the historical per-bit
// linear scan (vlc_match, see git history), which was ~half the decode
// time of a CAVLC stream; see cavlc_vlc.h.
struct CavlcLuts {
  VlcTable coeff_token[3];           // Table 9-5, nC bands <2 / <4 / <8
  VlcTable chroma_dc_ct;             // Table 9-5, nC == -1
  VlcTable chroma_dc422_ct;          // Table 9-5, nC == -2
  VlcTable total_zeros[15];          // Tables 9-7/9-8 per TotalCoeff
  VlcTable chroma_dc_tz[3];          // Table 9-9(a)
  VlcTable chroma_dc422_tz[7];       // Table 9-9(b)
  VlcTable run_before[7];            // Table 9-10 per zerosLeft (cap 7)
  CavlcLuts() {
    for (int t = 0; t < 3; t++)
      coeff_token[t].build(kCoeffTokenLen[t], kCoeffTokenBits[t], 68);
    chroma_dc_ct.build(kChromaDcCoeffTokenLen, kChromaDcCoeffTokenBits, 20);
    chroma_dc422_ct.build(kChromaDc422CoeffTokenLen,
                          kChromaDc422CoeffTokenBits, 36);
    for (int t = 0; t < 15; t++)
      total_zeros[t].build(kTotalZerosLen[t], kTotalZerosBits[t], 16);
    for (int t = 0; t < 3; t++)
      chroma_dc_tz[t].build(kChromaDcTotalZerosLen[t],
                            kChromaDcTotalZerosBits[t], 4);
    for (int t = 0; t < 7; t++)
      chroma_dc422_tz[t].build(kChromaDc422TotalZerosLen[t],
                               kChromaDc422TotalZerosBits[t], 8);
    for (int t = 0; t < 7; t++)
      run_before[t].build(kRunBeforeLen[t], kRunBeforeBits[t], 16);
  }
};
const CavlcLuts kCavlcLuts;

// te(v) — truncated Exp-Golomb (9.1).
int read_te(BitReader& br, int range) {
  if (range == 1) return br.read_bit() ^ 1;
  return (int)br.read_ue();
}

}  // namespace

int EntropyDecoder::nc_luma(int mb_x, int mb_y, int blk, int plane) {
  int x4 = blk & 3, y4 = blk >> 2;
  MbCtx* cur = &mbs_[plane_off_ + (size_t)mb_y * mb_w_ + mb_x];
  int na = -1, nb = -1;
  if (x4 > 0) {
    na = cur->nnz4[plane][blk - 1];
  } else {
    MbCtx* m = nba_;
    if (m) na = m->pcm ? 16 : m->nnz4[plane][y4 * 4 + 3];
  }
  if (y4 > 0) {
    nb = cur->nnz4[plane][blk - 4];
  } else {
    MbCtx* m = nbb_;
    if (m) nb = m->pcm ? 16 : m->nnz4[plane][12 + x4];
  }
  if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
  if (na >= 0) return na;
  if (nb >= 0) return nb;
  return 0;
}

int EntropyDecoder::nc_chroma(int mb_x, int mb_y, int comp, int blk) {
  // 2-wide chroma AC grid: 2x2 in 4:2:0, 2x4 in 4:2:2.
  int x2 = blk & 1, y2 = blk >> 1;
  int last_row = ch_ac_blocks() / 2 - 1;
  MbCtx* cur = &mbs_[plane_off_ + (size_t)mb_y * mb_w_ + mb_x];
  int na = -1, nb = -1;
  if (x2 > 0) {
    na = cur->nnzc[comp][blk - 1];
  } else {
    MbCtx* m = nba_;
    if (m) na = m->pcm ? 16 : m->nnzc[comp][y2 * 2 + 1];
  }
  if (y2 > 0) {
    nb = cur->nnzc[comp][blk - 2];
  } else {
    MbCtx* m = nbb_;
    if (m) nb = m->pcm ? 16 : m->nnzc[comp][last_row * 2 + x2];
  }
  if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
  if (na >= 0) return na;
  if (nb >= 0) return nb;
  return 0;
}

// Parse one CAVLC residual block (9.2); returns TotalCoeff (or -1 on a
// malformed stream).
int EntropyDecoder::cavlc_residual(BitReader& br, int nc, int max_coeff) {
  int tc, t1;
  if (nc == -1) {  // chroma DC (4:2:0)
    int idx = kCavlcLuts.chroma_dc_ct.decode(br);
    if (idx < 0) return -1;
    tc = idx >> 2;
    t1 = idx & 3;
  } else if (nc == -2) {  // chroma DC (4:2:2), Table 9-5 nC == -2
    int idx = kCavlcLuts.chroma_dc422_ct.decode(br);
    if (idx < 0) return -1;
    tc = idx >> 2;
    t1 = idx & 3;
  } else if (nc < 8) {
    int tab = nc < 2 ? 0 : (nc < 4 ? 1 : 2);
    int idx = kCavlcLuts.coeff_token[tab].decode(br);
    if (idx < 0) return -1;
    tc = idx >> 2;
    t1 = idx & 3;
  } else {  // FLC, 6 bits
    uint32_t v = br.read_bits(6);
    if (v == 3) {
      tc = 0;
      t1 = 0;
    } else {
      tc = (int)(v >> 2) + 1;
      t1 = (int)(v & 3);
    }
  }
  if (tc == 0) return 0;
  if (tc > max_coeff) return -1;

  // trailing one signs (values unused by entropy-only decode)
  br.consume(t1);

  // levels (9.2.2.1)
  int suffix_length = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int i = t1; i < tc; i++) {
    // level_prefix: leading-zero count via one 24-bit peek (conforming
    // prefixes are < 16); bit-loop fallback for longer/corrupt codes.
    int prefix = 0;
    uint32_t w = br.peek_bits(24);
    if (w) {
      prefix = __builtin_clz(w) - 8;
      br.consume(prefix + 1);
    } else {
      while (br.read_bit() == 0 && prefix < 32 && !br.overrun()) prefix++;
    }
    int suffix_size;
    if (prefix == 14 && suffix_length == 0)
      suffix_size = 4;
    else if (prefix >= 15)
      suffix_size = prefix - 3;
    else
      suffix_size = suffix_length;
    int level_code = (prefix < 15 ? prefix : 15) << suffix_length;
    if (suffix_size > 0) level_code += (int)br.read_bits(suffix_size);
    if (prefix >= 15 && suffix_length == 0) level_code += 15;
    if (prefix >= 16) level_code += (1 << (prefix - 3)) - 4096;
    if (i == t1 && t1 < 3) level_code += 2;
    int level =
        (level_code % 2 == 0) ? (level_code + 2) >> 1 : -((level_code + 1) >> 1);
    if (suffix_length == 0) suffix_length = 1;
    if (std::abs(level) > (3 << (suffix_length - 1)) && suffix_length < 6)
      suffix_length++;
  }

  // total_zeros (9.2.3)
  int total_zeros = 0;
  if (tc < max_coeff) {
    int idx;
    if (nc == -1)
      idx = kCavlcLuts.chroma_dc_tz[tc - 1].decode(br);
    else if (nc == -2)  // Table 9-9(b), maxNumCoeff 8
      idx = kCavlcLuts.chroma_dc422_tz[tc - 1].decode(br);
    else
      idx = kCavlcLuts.total_zeros[tc - 1].decode(br);
    if (idx < 0) return -1;
    total_zeros = idx;
  }

  // run_before (9.2.3)
  int zeros_left = total_zeros;
  for (int i = 0; i < tc - 1 && zeros_left > 0; i++) {
    int row = std::min(zeros_left, 7) - 1;
    int idx = kCavlcLuts.run_before[row].decode(br);
    if (idx < 0) return -1;
    zeros_left -= idx;
    if (zeros_left < 0) return -1;
  }
  return tc;
}

int EntropyDecoder::decode_slice_cavlc(BitReader& br, int nal_type,
                                       int nal_ref_idc) {
  (void)nal_type;
  (void)nal_ref_idc;
  last_qp_delta_ = 0;
  trace_qp_ = sh_.slice_qp;
  if (trace_enabled())
    fprintf(stderr, "slice(cavlc): type=%d qp=%d first_mb=%d nref=%d/%d\n",
            sh_.type, sh_.slice_qp, sh_.first_mb_in_slice, sh_.num_ref_idx_l0,
            sh_.num_ref_idx_l1);

  bool b_slice = sh_.type == SLICE_B;
  bool p_slice = sh_.type == SLICE_P;
  bool i_slice = !b_slice && !p_slice;

  int mb_addr = sh_.first_mb_in_slice;
  int total = mb_w_ * pic_mb_rows_;
  bool more = true;
  // Incremental raster coords (see decode_slice).
  int mb_x = mb_addr % mb_w_;
  int mb_y = mb_addr / mb_w_;
  while (more && mb_addr < total) {
    if (!i_slice) {
      uint32_t skip_run = br.read_ue();
      if (br.overrun()) return -6;
      for (uint32_t k = 0; k < skip_run && mb_addr < total; k++) {
        MbCtx* cur = &mbs_[plane_off_ + mb_addr];
        cur->reset(gen_, slice_id_, /*zero_nnz=*/true);
        nba_ = avail(mb_x - 1, mb_y);
        nbb_ = avail(mb_x, mb_y - 1);
        process_skip_mb(cur, mb_x, mb_y, p_slice);
        mb_addr++;
        if (++mb_x == mb_w_) { mb_x = 0; mb_y++; }
      }
      more = br.more_rbsp_data();
      if (!more || mb_addr >= total) break;
    }

    MbCtx* cur = &mbs_[plane_off_ + mb_addr];
    cur->reset(gen_, slice_id_, /*zero_nnz=*/true);
    nba_ = avail(mb_x - 1, mb_y);
    nbb_ = avail(mb_x, mb_y - 1);

    // ---- mb_type (ue + per-slice mapping, Tables 7-11/13/14) ----
    int code = (int)br.read_ue();
    int intra_code = -1, p_type = -1, b_type = -1;
    if (i_slice) {
      intra_code = code;
    } else if (p_slice) {
      if (code >= 5)
        intra_code = code - 5;
      else
        p_type = code;
    } else {
      if (code >= 23)
        intra_code = code - 23;
      else
        b_type = code;
    }
    cur->decoded = 1;
    if (intra_code == 25) {
      // I_PCM (7.3.5): pcm_alignment_zero_bits to a byte boundary, then
      // the raw samples are skipped (no pixel reconstruction here).
      while (!br.byte_aligned()) br.read_bit();
      br.skip(pcm_sample_bits());
      mark_pcm(cur);
      if (br.overrun()) return -6;
      if (trace_enabled())
        fprintf(stderr, "mb %d (%d,%d) cavlc pcm bitpos=%zu\n", mb_addr,
                mb_x, mb_y, br.bit_pos());
      mb_addr++;
      if (++mb_x == mb_w_) { mb_x = 0; mb_y++; }
      more = br.more_rbsp_data();
      continue;
    }
    if (intra_code > 25) return -6;

    int cbp_luma = 0, cbp_chroma = 0;
    bool intra = intra_code >= 0;
    cur->intra = intra;
    PartList parts;

    int cfi = chroma_array_type();
    if (intra) {
      cur->mb_class = MB_INTRA;
      if (intra_code == 0) {
        cur->intra_nxn = 1;
        if (active_pps_->transform_8x8_mode) cur->t8x8 = br.read_bit();
        int n = cur->t8x8 ? 4 : 16;
        // 4:4:4: Cb/Cr reuse the luma intra modes (no extra syntax).
        for (int i = 0; i < n; i++) {
          if (!br.read_bit()) br.read_bits(3);
        }
        if (cfi == 1 || cfi == 2)
          cur->chroma_mode = (uint8_t)br.read_ue();
      } else {
        cur->i16 = 1;
        int v = intra_code - 1;
        cbp_chroma = cfi == 3 ? 0 : (v / 4) % 3;
        cbp_luma = (v >= 12) ? 0xf : 0;
        if (cfi == 1 || cfi == 2)
          cur->chroma_mode = (uint8_t)br.read_ue();
      }
    } else if (p_slice) {
      int sub[4] = {0, 0, 0, 0};
      if (p_type == 3 || p_type == 4)
        for (int i = 0; i < 4; i++) {
          sub[i] = (int)br.read_ue();
          if (sub[i] > 3) return -6;  // 7.4.5.2: P sub_mb_type in [0,3]
        }
      build_parts_p(p_type, sub, cur, parts);
    } else {
      int sub[4] = {0, 0, 0, 0};
      if (b_type == 22)
        for (int i = 0; i < 4; i++) {
          sub[i] = (int)br.read_ue();
          if (sub[i] > 12) return -6;  // 7.4.5.2: B sub_mb_type in [0,12]
        }
      build_parts_b(b_type, sub, cur, parts);
    }

    // ---- inter prediction syntax: refs then mvds ----
    if (!intra && !parts.empty()) {
      bool ref0_forced = (p_type == 4);  // P_8x8ref0
      for (int list = 0; list < 2; list++) {
        int lbit = 1 << list;
        int active_refs = list == 0 ? sh_.num_ref_idx_l0 : sh_.num_ref_idx_l1;
        int last_i8 = -1, last_ref = 0;
        for (auto& pp : parts) {
          if (pp.direct || !(pp.list_mask & lbit)) continue;
          int i8 = (pp.y0 >= 2 ? 2 : 0) + (pp.x0 >= 2 ? 1 : 0);
          bool is_sub = cur->mb_class == MB_INTER_8X8;
          int r;
          if (is_sub && i8 == last_i8) {
            r = last_ref;
          } else {
            r = 0;
            if (active_refs > 1 && !ref0_forced) r = read_te(br, active_refs - 1);
            last_i8 = i8;
            last_ref = r;
          }
          pp.ref[list] = r;
          for (int yy = 0; yy < pp.h; yy++)
            for (int xx = 0; xx < pp.w; xx++)
              cur->ref4[list][(pp.y0 + yy) * 4 + pp.x0 + xx] = (int8_t)r;
        }
      }
      for (int list = 0; list < 2; list++) {
        int lbit = 1 << list;
        for (auto& pp : parts) {
          if (pp.direct || !(pp.list_mask & lbit)) continue;
          pp.mvd[list][0] = br.read_se();
          pp.mvd[list][1] = br.read_se();
        }
      }
    }

    // ---- coded_block_pattern / transform size ----
    bool sub8x8_ok = sub_parts_8x8_ok(parts, cur);
    if (!cur->i16) {
      uint32_t me = br.read_ue();
      if (cfi == 0 || cfi == 3) {
        // Table 9-4's "ChromaArrayType 0 or 3" column (16 codes): no
        // chroma cbp part — in 4:4:4 the Cb/Cr residuals follow
        // CodedBlockPatternLuma (7.4.5).
        if (me >= 16) return -6;
        cbp_luma = (cur->intra_nxn ? kGolombToIntra4x4CbpGray
                                   : kGolombToInterCbpGray)[me];
      } else {
        if (me >= 48) return -6;
        cbp_luma =
            (cur->intra_nxn ? kGolombToIntra4x4Cbp : kGolombToInterCbp)[me];
      }
      cbp_chroma = cbp_luma >> 4;
      cbp_luma &= 0xf;
      cur->cbp_luma = (uint8_t)cbp_luma;
      cur->cbp_chroma = (uint8_t)cbp_chroma;
      if (cbp_luma && active_pps_->transform_8x8_mode && !cur->intra_nxn &&
          sub8x8_ok && (b_type != 0 || active_sps_->direct_8x8_inference)) {
        cur->t8x8 = br.read_bit();
      }
    } else {
      cur->cbp_luma = (uint8_t)cbp_luma;
      cur->cbp_chroma = (uint8_t)cbp_chroma;
    }

    // ---- residual (9.2) ----
    int nnz = 0;
    bool have_residual = cbp_luma || cbp_chroma || cur->i16;
    if (have_residual) {
      int dq = br.read_se();
      last_qp_delta_ = dq;
      trace_qp_ = ((trace_qp_ + dq) % 52 + 52) % 52;
      // Luma-syntax planes: Y, plus Cb/Cr in 4:4:4 (gated by the SAME
      // CodedBlockPatternLuma; per-plane nC neighborhoods).
      int planes = cfi == 3 ? 3 : 1;
      for (int pl = 0; pl < planes; pl++) {
        if (cur->i16) {
          int n = cavlc_residual(br, nc_luma(mb_x, mb_y, 0, pl), 16);
          if (n < 0) return -6;
          nnz += n;
          if (n > 0) cur->cbf_luma_dc |= 1u << pl;
        }
        for (int i8 = 0; i8 < 4; i8++) {
          if (!((cbp_luma >> i8) & 1)) continue;
          // CAVLC codes 8x8-transform blocks as 4 interleaved 4x4
          // scans — identical parsing either way.
          for (int i4 = 0; i4 < 4; i4++) {
            int blk = blk_raster(i8, i4);
            int n = cavlc_residual(br, nc_luma(mb_x, mb_y, blk, pl),
                                   cur->i16 ? 15 : 16);
            if (n < 0) return -6;
            nnz += n;
            cur->nnz4[pl][blk] = (uint8_t)n;
            if (n) cur->cbf_luma[pl] |= 1u << blk;
          }
        }
      }
      if (cfi == 1 || cfi == 2) {
        // Chroma DC nC: -1 selects the 4-coeff 4:2:0 tables, -2 the
        // 8-coeff 4:2:2 tables (9.2.1, Table 9-5 / 9-9).
        int dc_nc = active_sps_->chroma_format_idc == 2 ? -2 : -1;
        if (cbp_chroma) {
          for (int comp = 0; comp < 2; comp++) {
            int n = cavlc_residual(br, dc_nc, ch_dc_coeffs());
            if (n < 0) return -6;
            nnz += n;
            if (n) cur->cbf_chroma_dc |= 1u << comp;
          }
        }
        if (cbp_chroma == 2) {
          for (int comp = 0; comp < 2; comp++) {
            for (int blk = 0; blk < ch_ac_blocks(); blk++) {
              int n = cavlc_residual(br, nc_chroma(mb_x, mb_y, comp, blk), 15);
              if (n < 0) return -6;
              nnz += n;
              cur->nnzc[comp][blk] = (uint8_t)n;
              if (n) cur->cbf_chroma_ac[comp] |= 1u << blk;
            }
          }
        }
      }
    } else {
      last_qp_delta_ = 0;
    }
    cur->nnz_total = (uint16_t)nnz;

    if (!intra) reconstruct_inter(cur, parts, mb_x, mb_y);

    if (trace_enabled())
      fprintf(stderr,
              "mb %d (%d,%d) cavlc intra=%d code=%d t8=%d cbpL=%x cbpC=%d "
              "nnz=%d qp=%d\n",
              mb_addr, mb_x, mb_y, (int)cur->intra, code, (int)cur->t8x8,
              cbp_luma, cbp_chroma, nnz, trace_qp_);
    finish_mb_output(cur);
    if (br.overrun()) return -6;
    mb_addr++;
    if (++mb_x == mb_w_) { mb_x = 0; mb_y++; }
    more = br.more_rbsp_data();
  }
  return br.overrun() ? -6 : 0;
}

}  // namespace cova


