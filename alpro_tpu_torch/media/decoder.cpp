// libalpro_media — native video decode for the alpro_tpu_torch input pipeline
// (the JAX package's alpro_tpu/media/decoder.cpp, the same code).
//
// Replacement for the decord dependency used by the reference ALPRO data
// layer (its src/datasets/dataset_base.py:137-182):
// seek-and-decode exactly the sampled frames, with in-decoder swscale resize
// to RGB24, writing straight into a caller-provided (numpy) buffer.
//
// C ABI:
//   alpro_probe(path, &num_frames, &width, &height, &fps)
//   alpro_decode_frames(path, indices, n, out_w, out_h, out_buf)
//   alpro_encode_test_video(path, w, h, n_frames, seed)   (MJPEG/AVI fixture
//       writer so decode tests need no dataset downloads)
//
// Build: alpro_tpu_torch/media/binding.py runs this directory's Makefile at
// first use, into alpro_tpu_torch/_build/.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// silence per-frame libav chatter (e.g. swscaler yuvj deprecation warnings)
// in worker threads; real failures surface through return codes
struct QuietLog {
  QuietLog() { av_log_set_level(AV_LOG_ERROR); }
} quiet_log_;

struct Demux {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_idx = -1;

  ~Demux() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    stream_idx =
        av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (stream_idx < 0) return -3;
    const AVCodec* codec =
        avcodec_find_decoder(fmt->streams[stream_idx]->codecpar->codec_id);
    if (!codec) return -4;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return -5;
    if (avcodec_parameters_to_context(dec, fmt->streams[stream_idx]->codecpar) < 0)
      return -6;
    if (avcodec_open2(dec, codec, nullptr) < 0) return -7;
    return 0;
  }

  AVStream* stream() const { return fmt->streams[stream_idx]; }

  double fps() const {
    AVRational r = stream()->avg_frame_rate;
    if (r.num == 0 || r.den == 0) r = stream()->r_frame_rate;
    return (r.den > 0) ? av_q2d(r) : 0.0;
  }

  int64_t num_frames() const {
    AVStream* st = stream();
    if (st->nb_frames > 0) return st->nb_frames;
    double f = fps();
    if (st->duration > 0 && f > 0)
      return (int64_t)(st->duration * av_q2d(st->time_base) * f + 0.5);
    if (fmt->duration > 0 && f > 0)
      return (int64_t)((double)fmt->duration / AV_TIME_BASE * f + 0.5);
    return -1;
  }
};

// Forward scan with keyframe seeks between sparse targets — the decord
// seek-and-decode trick, run by alpro_decode_frames.
static int decode_targets(Demux& d, SwsContext* sws,
                          std::vector<std::pair<int64_t, int>>& targets,
                          int out_w, int out_h, uint8_t* out_buf) {
  AVFrame* frame = av_frame_alloc();
  // survives EOF: avcodec_receive_frame unrefs its dst on entry, so after
  // the final (failing) receive `frame` is empty — past-EOF targets must
  // clamp to a frame we still hold a reference to
  AVFrame* last = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  const size_t frame_bytes = (size_t)out_w * out_h * 3;
  const double fps = d.fps();
  const AVRational tb = d.stream()->time_base;
  // containers can start at a nonzero pts (MPEG-TS, edit lists); frame
  // indices count from the stream's own start, not absolute pts
  const int64_t start_pts =
      d.stream()->start_time != AV_NOPTS_VALUE ? d.stream()->start_time : 0;

  int64_t cur = -1;  // index of the last decoded frame
  size_t ti = 0;
  int err = 0;
  bool got_any = false;

  auto emit = [&](AVFrame* f, int64_t frame_idx) {
    while (ti < targets.size() && targets[ti].first == frame_idx) {
      uint8_t* dst[1] = {out_buf + frame_bytes * targets[ti].second};
      int dst_stride[1] = {out_w * 3};
      sws_scale(sws, f->data, f->linesize, 0, d.dec->height, dst, dst_stride);
      ++ti;
    }
  };

  // receive every pending frame from the decoder, tracking the frame index
  auto drain = [&]() {
    while (avcodec_receive_frame(d.dec, frame) == 0) {
      if (cur < 0 && fps > 0 && frame->pts != AV_NOPTS_VALUE)
        cur = (int64_t)((frame->pts - start_pts) * av_q2d(tb) * fps + 0.5);
      else
        ++cur;
      emit(frame, cur);
      got_any = true;
      av_frame_unref(last);
      av_frame_move_ref(last, frame);  // frame is clean for the next receive
    }
  };

  while (ti < targets.size() && err == 0) {
    int64_t want = targets[ti].first;
    // seek forward jumps: if the next target is far ahead, keyframe-seek
    if (want > cur + 64 && fps > 0) {
      int64_t ts = start_pts + (int64_t)((double)want / fps / av_q2d(tb));
      if (av_seek_frame(d.fmt, d.stream_idx, ts, AVSEEK_FLAG_BACKWARD) >= 0) {
        avcodec_flush_buffers(d.dec);
        cur = -1;  // unknown until the first decoded pts
      }
    }
    got_any = false;
    while (ti < targets.size()) {
      int r = av_read_frame(d.fmt, pkt);
      if (r < 0) {  // EOF: flush
        avcodec_send_packet(d.dec, nullptr);
        drain();
        // remaining targets past EOF: clamp to the last decoded frame
        // (`last`, not `frame` — the failed receive left `frame` empty,
        // and `last` also covers frames decoded in an earlier scan pass)
        while (ti < targets.size() && last->data[0]) {
          uint8_t* dst[1] = {out_buf + frame_bytes * targets[ti].second};
          int dst_stride[1] = {out_w * 3};
          sws_scale(sws, last->data, last->linesize, 0, d.dec->height, dst,
                    dst_stride);
          ++ti;
        }
        if (ti < targets.size()) err = -9;
        break;
      }
      if (pkt->stream_index != d.stream_idx) {
        av_packet_unref(pkt);
        continue;
      }
      int s = avcodec_send_packet(d.dec, pkt);
      if (s == AVERROR(EAGAIN)) {
        // decoder output queue full: drain, then RESEND this packet —
        // dropping it would silently shift every later frame index
        drain();
        s = avcodec_send_packet(d.dec, pkt);
      }
      av_packet_unref(pkt);
      if (s < 0) continue;  // undecodable packet: skip it
      drain();
      if (ti >= targets.size()) break;
      // if we've decoded past the last target, stop
      if (cur > targets.back().first) break;
    }
    if (!got_any && err == 0 && ti < targets.size()) {
      // seek landed badly; fall back to linear decode from start
      if (av_seek_frame(d.fmt, d.stream_idx, 0,
                        AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_BYTE) < 0)
        err = -10;
      avcodec_flush_buffers(d.dec);
      cur = -1;
    }
  }

  av_frame_free(&frame);
  av_frame_free(&last);
  av_packet_free(&pkt);
  return (ti == targets.size()) ? 0 : (err ? err : -11);
}

}  // namespace

extern "C" {

int alpro_probe(const char* path, int64_t* num_frames, int* width, int* height,
                double* fps) {
  Demux d;
  int rc = d.open(path);
  if (rc != 0) return rc;
  *num_frames = d.num_frames();
  *width = d.dec->width;
  *height = d.dec->height;
  *fps = d.fps();
  return 0;
}

// One-shot decode (original API): open + read + close. Kept for callers
// that touch each container once; it re-pays the per-clip open cost.
int alpro_decode_frames(const char* path, const int64_t* indices, int n,
                        int out_w, int out_h, uint8_t* out_buf) {
  if (n <= 0 || out_w <= 0 || out_h <= 0) return -100;
  Demux d;
  int rc = d.open(path);
  if (rc != 0) return rc;

  std::vector<std::pair<int64_t, int>> targets(n);
  for (int i = 0; i < n; ++i) targets[i] = {indices[i], i};
  std::sort(targets.begin(), targets.end());

  SwsContext* sws =
      sws_getContext(d.dec->width, d.dec->height, d.dec->pix_fmt, out_w, out_h,
                     AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!sws) return -8;
  rc = decode_targets(d, sws, targets, out_w, out_h, out_buf);
  sws_freeContext(sws);
  return rc;
}

// Repack HWC uint8 frames into patch-major (N, p*p*C) vectors — the
// layout the TimeSformer patch embedding's matmul consumes. Doing this on
// the host (one linear pass, cache-friendly) removes the strided patchify
// transpose from the device entirely.
//   in:  frames (n_frames, H, W, C) uint8
//   out: (n_frames, (H/p)*(W/p), p*p*C) uint8
int alpro_repack_patches(const uint8_t* frames, int n_frames, int H, int W,
                         int C, int p, uint8_t* out) {
  if (H % p != 0 || W % p != 0) return -1;
  const int hp = H / p, wp = W / p;
  const size_t row_bytes = (size_t)W * C;
  const size_t patch_row_bytes = (size_t)p * C;
  const size_t patch_bytes = (size_t)p * p * C;
  const size_t frame_in = (size_t)H * row_bytes;
  const size_t frame_out = (size_t)hp * wp * patch_bytes;
  for (int f = 0; f < n_frames; ++f) {
    const uint8_t* src = frames + f * frame_in;
    uint8_t* dst = out + f * frame_out;
    for (int ph = 0; ph < hp; ++ph) {
      for (int i = 0; i < p; ++i) {
        const uint8_t* row = src + ((size_t)(ph * p + i)) * row_bytes;
        for (int pw = 0; pw < wp; ++pw) {
          memcpy(dst + ((size_t)(ph * wp + pw)) * patch_bytes +
                     (size_t)i * patch_row_bytes,
                 row + (size_t)pw * patch_row_bytes, patch_row_bytes);
        }
      }
    }
  }
  return 0;
}

// Write a procedurally generated MJPEG/AVI clip (test fixture).
// start_pts (in the encoder's 1/25 time base) shifts the stream's first
// timestamp — fixtures for containers that do not start at pts 0 (MPEG-TS,
// edit-listed files), the case the decoder's start_time handling covers.
// Container is inferred from the path extension (falls back to AVI).
int alpro_encode_test_video(const char* path, int w, int h, int n_frames,
                            int seed, int64_t start_pts) {
  AVFormatContext* fmt = nullptr;
  avformat_alloc_output_context2(&fmt, nullptr, nullptr, path);
  if (!fmt) avformat_alloc_output_context2(&fmt, nullptr, "avi", path);
  if (!fmt) return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MJPEG);
  if (!codec) return -2;
  AVStream* st = avformat_new_stream(fmt, codec);
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  enc->width = w;
  enc->height = h;
  enc->pix_fmt = AV_PIX_FMT_YUVJ420P;
  enc->time_base = {1, 25};
  enc->color_range = AVCOL_RANGE_JPEG;
  st->time_base = enc->time_base;
  if (avcodec_open2(enc, codec, nullptr) < 0) return -3;
  avcodec_parameters_from_context(st->codecpar, enc);
  if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  if (avformat_write_header(fmt, nullptr) < 0) return -5;

  AVFrame* frame = av_frame_alloc();
  frame->format = enc->pix_fmt;
  frame->width = w;
  frame->height = h;
  av_frame_get_buffer(frame, 0);
  AVPacket* pkt = av_packet_alloc();

  uint32_t rng = (uint32_t)seed * 2654435761u + 12345u;
  for (int i = 0; i < n_frames; ++i) {
    av_frame_make_writable(frame);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        frame->data[0][y * frame->linesize[0] + x] =
            (uint8_t)((x * 3 + y * 5 + i * 29 + (rng >> 16)) & 0xFF);
    for (int y = 0; y < h / 2; ++y)
      for (int x = 0; x < w / 2; ++x) {
        frame->data[1][y * frame->linesize[1] + x] =
            (uint8_t)(128 + ((i * 13 + x) & 0x3F));
        frame->data[2][y * frame->linesize[2] + x] =
            (uint8_t)(128 + ((i * 7 + y) & 0x3F));
      }
    frame->pts = start_pts + i;
    if (avcodec_send_frame(enc, frame) < 0) return -6;
    while (avcodec_receive_packet(enc, pkt) == 0) {
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
    }
  }
  avcodec_send_frame(enc, nullptr);
  while (avcodec_receive_packet(enc, pkt) == 0) {
    av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
    pkt->stream_index = st->index;
    av_interleaved_write_frame(fmt, pkt);
  }
  av_write_trailer(fmt);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  avcodec_free_context(&enc);
  avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return 0;
}

}  // extern "C"
