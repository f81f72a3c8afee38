// Selective pixel decoder over libavcodec, bound at run time.
//
// libavcodec is opened with dlopen and called through the few entry
// points below, declared here instead of taken from FFmpeg's headers:
// the library this builds against need not ship headers (a host may
// carry libavcodec only as the private copy inside a Python wheel), and
// the first-party codec library (libcovacodec.so) never links it. The
// struct fields touched are the ones whose offsets FFmpeg has kept
// fixed across libavcodec 57-62 / libavutil 57-60; cova_pixdec_load
// refuses any other major version, and every decoded frame is checked
// against the packets sent (its pts must be one of theirs, its pixel
// format 8-bit 4:2:0), so a layout mismatch fails instead of decoding
// garbage.

#include "pixdec.h"

#include <dlfcn.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>

namespace cova {
namespace {

// ---- FFmpeg ABI subset ----------------------------------------------------

constexpr int kCodecIdH264 = 27;           // AV_CODEC_ID_H264
constexpr int kMediaTypeVideo = 0;         // AVMEDIA_TYPE_VIDEO
constexpr int kSideDataMotionVectors = 8;  // AV_FRAME_DATA_MOTION_VECTORS
constexpr int kEagain = -11;               // AVERROR(EAGAIN)
constexpr int kEof = -0x20464F45;          // AVERROR_EOF
constexpr int kPadding = 64;               // AV_INPUT_BUFFER_PADDING_SIZE
constexpr int kPixFmtYuv420p = 0, kPixFmtYuvj420p = 12;

struct AVFrameHead {  // AVFrame, leading fields
  uint8_t* data[8];
  int linesize[8];
  uint8_t** extended_data;
  int width, height, nb_samples, format;
};
constexpr size_t kFramePtsOffset = 136;  // AVFrame.pts

struct AVPacketHead {  // AVPacket, leading fields
  void* buf;
  int64_t pts, dts;
  uint8_t* data;
  int size;
};

struct AVCodecParametersHead {  // AVCodecParameters, leading fields
  int codec_type, codec_id;
  uint32_t codec_tag;
  uint8_t* extradata;
  int extradata_size;
};

struct AVFrameSideDataHead {
  int type;
  uint8_t* data;
  size_t size;
};

struct AVMotionVector {
  int32_t source;
  uint8_t w, h;
  int16_t src_x, src_y, dst_x, dst_y;
  uint64_t flags;
  int32_t motion_x, motion_y;
  uint16_t motion_scale;
};

struct Api {
  unsigned (*avcodec_version)();
  unsigned (*avutil_version)();
  const void* (*avcodec_find_decoder)(int);
  void* (*avcodec_alloc_context3)(const void*);
  void (*avcodec_free_context)(void**);
  void* (*avcodec_parameters_alloc)();
  void (*avcodec_parameters_free)(void**);
  int (*avcodec_parameters_to_context)(void*, const void*);
  int (*avcodec_open2)(void*, const void*, void**);
  int (*avcodec_send_packet)(void*, const void*);
  int (*avcodec_receive_frame)(void*, void*);
  void (*avcodec_flush_buffers)(void*);
  void* (*av_packet_alloc)();
  void (*av_packet_free)(void**);
  int (*av_new_packet)(void*, int);
  void (*av_packet_unref)(void*);
  void* (*av_frame_alloc)();
  void (*av_frame_free)(void**);
  void (*av_frame_unref)(void*);
  void* (*av_frame_get_side_data)(const void*, int);
  int (*av_opt_set)(void*, const char*, const char*, int);
  void* (*av_mallocz)(size_t);
  void (*av_log_set_level)(int);
};

Api g_api;
bool g_loaded = false;
std::string g_error = "libavcodec not loaded";
std::mutex g_load_mu;

int64_t frame_pts(const void* frame) {
  int64_t pts;
  memcpy(&pts, (const uint8_t*)frame + kFramePtsOffset, sizeof pts);
  return pts;
}

bool load_locked(const char* path) {
  if (g_loaded) return true;
  void* h = nullptr;
  if (path && *path) {
    h = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  } else {
    const char* names[] = {"libavcodec.so",    "libavcodec.so.62",
                           "libavcodec.so.61", "libavcodec.so.60",
                           "libavcodec.so.59", "libavcodec.so.58",
                           "libavcodec.so.57"};
    for (const char* n : names)
      if ((h = dlopen(n, RTLD_NOW | RTLD_LOCAL))) break;
  }
  if (!h) {
    const char* e = dlerror();
    g_error = std::string("cannot open libavcodec: ") + (e ? e : "not found");
    return false;
  }
  Api a;
  bool missing = false;
  // dlsym on the avcodec handle also searches its dependencies, which
  // is where the libavutil entry points live.
#define SYM(name)                                              \
  a.name = reinterpret_cast<decltype(a.name)>(dlsym(h, #name)); \
  if (!a.name) {                                               \
    g_error = "libavcodec lacks " #name;                       \
    missing = true;                                            \
  }
  SYM(avcodec_version) SYM(avutil_version) SYM(avcodec_find_decoder)
  SYM(avcodec_alloc_context3) SYM(avcodec_free_context)
  SYM(avcodec_parameters_alloc) SYM(avcodec_parameters_free)
  SYM(avcodec_parameters_to_context) SYM(avcodec_open2)
  SYM(avcodec_send_packet) SYM(avcodec_receive_frame)
  SYM(avcodec_flush_buffers) SYM(av_packet_alloc) SYM(av_packet_free)
  SYM(av_new_packet) SYM(av_packet_unref) SYM(av_frame_alloc)
  SYM(av_frame_free) SYM(av_frame_unref) SYM(av_frame_get_side_data)
  SYM(av_opt_set) SYM(av_mallocz) SYM(av_log_set_level)
#undef SYM
  if (missing) return false;
  unsigned lavc = a.avcodec_version() >> 16, lavu = a.avutil_version() >> 16;
  if (lavc < 57 || lavc > 62 || lavu < 57 || lavu > 60) {
    char buf[128];
    snprintf(buf, sizeof buf,
             "unsupported FFmpeg ABI: libavcodec %u / libavutil %u", lavc,
             lavu);
    g_error = buf;
    return false;
  }
  if (!a.avcodec_find_decoder(kCodecIdH264)) {
    g_error = "libavcodec has no H.264 decoder";
    return false;
  }
  g_api = a;
  g_loaded = true;
  g_error.clear();
  return true;
}

}  // namespace

bool load_libavcodec(const char* path) {
  std::lock_guard<std::mutex> lock(g_load_mu);
  return load_locked(path);
}

const char* libavcodec_error() { return g_error.c_str(); }

PixelDecoder::PixelDecoder(const uint8_t* extradata, size_t extradata_size,
                           bool export_mvs) {
  if (!load_libavcodec(nullptr)) return;
  const Api& a = g_api;
  const void* codec = a.avcodec_find_decoder(kCodecIdH264);
  void* ctx = a.avcodec_alloc_context3(codec);
  if (!ctx) return;
  if (extradata && extradata_size) {
    void* par = a.avcodec_parameters_alloc();
    auto* p = (AVCodecParametersHead*)par;
    p->codec_type = kMediaTypeVideo;
    p->codec_id = kCodecIdH264;
    p->extradata = (uint8_t*)a.av_mallocz(extradata_size + kPadding);
    memcpy(p->extradata, extradata, extradata_size);
    p->extradata_size = (int)extradata_size;
    int rc = a.avcodec_parameters_to_context(ctx, par);
    a.avcodec_parameters_free(&par);
    if (rc < 0) {
      a.avcodec_free_context(&ctx);
      return;
    }
  }
  if (export_mvs) a.av_opt_set(ctx, "flags2", "+export_mvs", 0);
  // Debug aid: COVA_PIXDEC_DEBUG=1 prints libavcodec's per-MB type map,
  // the localization oracle for entropy-decoder parity work.
  if (getenv("COVA_PIXDEC_DEBUG")) {
    a.av_opt_set(ctx, "debug", "mb_type+qp", 0);
    a.av_log_set_level(48);  // AV_LOG_DEBUG
  }
  a.av_opt_set(ctx, "threads", "auto", 0);
  if (a.avcodec_open2(ctx, codec, nullptr) < 0) {
    a.avcodec_free_context(&ctx);
    return;
  }
  ctx_ = ctx;
  frame_ = a.av_frame_alloc();
  pkt_ = a.av_packet_alloc();
  ok_ = ctx_ && frame_ && pkt_;
}

PixelDecoder::~PixelDecoder() {
  if (!g_loaded) return;
  if (pkt_) g_api.av_packet_free(&pkt_);
  if (frame_) g_api.av_frame_free(&frame_);
  if (ctx_) g_api.avcodec_free_context(&ctx_);
}

bool PixelDecoder::receive_all(std::vector<DecodedFrame>* out) {
  const Api& a = g_api;
  while (true) {
    int rc = a.avcodec_receive_frame(ctx_, frame_);
    if (rc == kEagain || rc == kEof) return true;
    if (rc < 0) return false;
    const auto* frame = (const AVFrameHead*)frame_;
    DecodedFrame df;
    df.width = frame->width;
    df.height = frame->height;
    df.pts = frame_pts(frame_);
    if ((frame->format != kPixFmtYuv420p && frame->format != kPixFmtYuvj420p) ||
        !pending_pts_.count(df.pts)) {
      a.av_frame_unref(frame_);
      return false;  // not 8-bit 4:2:0, or an ABI mismatch
    }
    pending_pts_.erase(pending_pts_.find(df.pts));
    int w = frame->width, h = frame->height;
    df.y.resize((size_t)w * h);
    df.u.resize((size_t)(w / 2) * (h / 2));
    df.v.resize((size_t)(w / 2) * (h / 2));
    for (int r = 0; r < h; r++)
      memcpy(&df.y[(size_t)r * w], frame->data[0] + (size_t)r * frame->linesize[0], w);
    for (int r = 0; r < h / 2; r++) {
      memcpy(&df.u[(size_t)r * (w / 2)],
             frame->data[1] + (size_t)r * frame->linesize[1], w / 2);
      memcpy(&df.v[(size_t)r * (w / 2)],
             frame->data[2] + (size_t)r * frame->linesize[2], w / 2);
    }
    auto* sd = (const AVFrameSideDataHead*)a.av_frame_get_side_data(
        frame_, kSideDataMotionVectors);
    if (sd) {
      const auto* mvs = (const AVMotionVector*)sd->data;
      size_t n = sd->size / sizeof(AVMotionVector);
      df.mvs.reserve(n * 7);
      for (size_t i = 0; i < n; i++) {
        const AVMotionVector& m = mvs[i];
        // Normalize motion to quarter-pel.
        int32_t mx = m.motion_scale ? m.motion_x * 4 / m.motion_scale : 0;
        int32_t my = m.motion_scale ? m.motion_y * 4 / m.motion_scale : 0;
        df.mvs.push_back(mx);
        df.mvs.push_back(my);
        df.mvs.push_back((int32_t)m.dst_x);
        df.mvs.push_back((int32_t)m.dst_y);
        df.mvs.push_back((int32_t)m.w);
        df.mvs.push_back((int32_t)m.h);
        df.mvs.push_back((int32_t)m.source);
      }
    }
    out->push_back(std::move(df));
    a.av_frame_unref(frame_);
  }
}

bool PixelDecoder::send(const uint8_t* data, size_t size, int64_t pts,
                        std::vector<DecodedFrame>* out) {
  if (!ok_) return false;
  const Api& a = g_api;
  if (a.av_new_packet(pkt_, (int)size) < 0) return false;
  auto* pkt = (AVPacketHead*)pkt_;
  memcpy(pkt->data, data, size);
  pkt->pts = pts;
  pending_pts_.insert(pts);
  int rc = a.avcodec_send_packet(ctx_, pkt_);
  a.av_packet_unref(pkt_);
  if (rc < 0 && rc != kEagain) return false;
  return receive_all(out);
}

bool PixelDecoder::flush(std::vector<DecodedFrame>* out) {
  if (!ok_) return false;
  g_api.avcodec_send_packet(ctx_, nullptr);
  bool r = receive_all(out);
  g_api.avcodec_flush_buffers(ctx_);
  pending_pts_.clear();
  return r;
}

}  // namespace cova

// ---------------------------------------------------------------------------
// C API for ctypes binding (cova_tpu/codec/__init__.py, PixelDecoder)
// ---------------------------------------------------------------------------

using namespace cova;

namespace {
struct PixDecHandle {
  std::unique_ptr<PixelDecoder> dec;
  std::deque<DecodedFrame> frames;
  DecodedFrame last;  // last popped frame (for MV queries)
};
}  // namespace

extern "C" {

// Open libavcodec from `path` (nullptr: the default library names).
// Returns 0 on success; otherwise copies the reason into err.
int cova_pixdec_load(const char* path, char* err, int errlen) {
  if (load_libavcodec(path)) return 0;
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", libavcodec_error());
  return -1;
}

void* cova_pixdec_create(const uint8_t* extradata, int size, int export_mvs) {
  auto* h = new PixDecHandle();
  h->dec.reset(new PixelDecoder(extradata, (size_t)size, export_mvs != 0));
  if (!h->dec->ok()) {
    delete h;
    return nullptr;
  }
  return h;
}

void cova_pixdec_destroy(void* hv) { delete (PixDecHandle*)hv; }

// Send one AU; returns number of frames now queued, or -1 on error.
int cova_pixdec_send(void* hv, const uint8_t* au, int size, int64_t pts) {
  auto* h = (PixDecHandle*)hv;
  std::vector<DecodedFrame> out;
  if (!h->dec->send(au, (size_t)size, pts, &out)) return -1;
  for (auto& f : out) h->frames.push_back(std::move(f));
  return (int)h->frames.size();
}

int cova_pixdec_flush(void* hv) {
  auto* h = (PixDecHandle*)hv;
  std::vector<DecodedFrame> out;
  if (!h->dec->flush(&out)) return -1;
  for (auto& f : out) h->frames.push_back(std::move(f));
  return (int)h->frames.size();
}

// Pop the oldest queued frame into caller I420 buffers. Returns 1 on
// success, 0 if queue empty. Buffers must hold w*h and (w/2)*(h/2).
int cova_pixdec_pop(void* hv, uint8_t* y, uint8_t* u, uint8_t* v,
                    int64_t* pts, int* width, int* height) {
  auto* h = (PixDecHandle*)hv;
  if (h->frames.empty()) return 0;
  h->last = std::move(h->frames.front());
  h->frames.pop_front();
  *pts = h->last.pts;
  *width = h->last.width;
  *height = h->last.height;
  if (y) memcpy(y, h->last.y.data(), h->last.y.size());
  if (u) memcpy(u, h->last.u.data(), h->last.u.size());
  if (v) memcpy(v, h->last.v.data(), h->last.v.size());
  return 1;
}

// Motion vectors of the last popped frame: 7 int32 per record
// {mx_q4, my_q4, dst_x, dst_y, w, h, source}. Returns record count.
int cova_pixdec_last_mvs(void* hv, int32_t* buf, int cap_records) {
  auto* h = (PixDecHandle*)hv;
  int n = (int)(h->last.mvs.size() / 7);
  if (!buf) return n;
  if (n > cap_records) n = cap_records;
  memcpy(buf, h->last.mvs.data(), (size_t)n * 7 * sizeof(int32_t));
  return n;
}

}  // extern "C"
