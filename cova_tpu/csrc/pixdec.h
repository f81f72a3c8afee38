// Selective pixel decoder: wraps libavcodec's H.264 software decoder
// for the few frames the cova scheduler selects for full decode. This
// fills the role the NVDEC hardware decoder plays in the reference
// (reference: nvv4l2decoder in pipeline/cova/pipeline.py:304); the
// compressed-domain fast path never touches it. libavcodec is opened at
// run time (pixdec.cc), so this builds into its own library,
// libcovapix.so, that only the pixel stage loads.
//
// Also doubles as the validation oracle for the first-party entropy
// decoder: with export_mvs enabled, libavcodec's per-block motion vectors
// are compared against ours (see tests/test_codec.py).
#pragma once

#include <cstddef>
#include <cstdint>
#include <set>
#include <vector>

namespace cova {

struct DecodedFrame {
  int width = 0, height = 0;
  int64_t pts = 0;
  // Planar YUV420 (I420): y then u then v, tightly packed.
  std::vector<uint8_t> y, u, v;
  // Optional exported motion vectors (when export_mvs): packed records of
  // {src_x_q4, src_y_q4, dst_x_q4, dst_y_q4, w, h, source} int32s.
  std::vector<int32_t> mvs;
};

// Open libavcodec (`path`, or the default library names when null).
// Idempotent; false with libavcodec_error() set when unusable.
bool load_libavcodec(const char* path);
const char* libavcodec_error();

class PixelDecoder {
 public:
  // extradata = avcC blob (length-prefixed mode) or nullptr for Annex-B.
  PixelDecoder(const uint8_t* extradata, size_t extradata_size,
               bool export_mvs = false);
  ~PixelDecoder();
  PixelDecoder(const PixelDecoder&) = delete;
  PixelDecoder& operator=(const PixelDecoder&) = delete;

  bool ok() const { return ok_; }
  // Send one AU; decoded frames (if any) appended to `out`.
  bool send(const uint8_t* data, size_t size, int64_t pts,
            std::vector<DecodedFrame>* out);
  // Drain remaining frames at end of stream.
  bool flush(std::vector<DecodedFrame>* out);

 private:
  bool receive_all(std::vector<DecodedFrame>* out);
  void* ctx_ = nullptr;    // AVCodecContext*
  void* frame_ = nullptr;  // AVFrame*
  void* pkt_ = nullptr;    // AVPacket*
  std::multiset<int64_t> pending_pts_;  // sent, not yet decoded
  bool ok_ = false;
};

}  // namespace cova
