// xmtpu_torch FFmpeg shim: compressed-audio decode/encode (host front
// end), the port's own copy of the JAX package's xmtpu/native/xm_ffmpeg.cpp
// with the same C ABI.
//
// Demux + decode any FFmpeg-supported audio file to interleaved int16
// PCM at the file's own rate, and encode int16 PCM to a compressed file
// by its extension. The decoder converts the sample format only
// (swresample to s16 interleaved) and never resamples: rate conversion
// is a device op.
//
// Built by xmtpu_torch/native/ffmpeg.py at first use:
//   g++ -O2 -shared -fPIC -std=c++17 -I/usr/include/x86_64-linux-gnu
//       xm_ffmpeg.cpp -lavformat -lavcodec -lavutil -lswresample
// (FFmpeg 5.x, lavc 59 ch_layout API)

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

struct DecodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  ~DecodeCtx() {
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }
};

int drain_frames(DecodeCtx& c, std::vector<int16_t>& out, int nch) {
  int rc;
  std::vector<int16_t> buf;  // reused across frames (one grow, not
                             // one malloc per ~1024-sample frame)
  while ((rc = avcodec_receive_frame(c.dec, c.frame)) == 0) {
    int out_samples = swr_get_out_samples(c.swr, c.frame->nb_samples);
    buf.resize((size_t)out_samples * nch);
    uint8_t* outp = (uint8_t*)buf.data();
    int got = swr_convert(c.swr, &outp, out_samples,
                          (const uint8_t**)c.frame->extended_data,
                          c.frame->nb_samples);
    if (got < 0) return got;
    out.insert(out.end(), buf.begin(), buf.begin() + (size_t)got * nch);
    av_frame_unref(c.frame);
  }
  return rc == AVERROR(EAGAIN) || rc == AVERROR_EOF ? 0 : rc;
}

}  // namespace

extern "C" {

// Decode any FFmpeg-supported audio file to interleaved int16 at the
// file's NATIVE sample rate. Caller frees *out with xm_free (malloc'd).
int xm_ff_decode(const char* path, int16_t** out, int64_t* n_frames,
                 int32_t* channels, int32_t* sample_rate) {
  DecodeCtx c;
  if (avformat_open_input(&c.fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(c.fmt, nullptr) < 0) return -1;
  const AVCodec* codec = nullptr;
  int sidx = av_find_best_stream(c.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (sidx < 0 || !codec) return -2;
  AVStream* st = c.fmt->streams[sidx];
  c.dec = avcodec_alloc_context3(codec);
  if (!c.dec) return -3;
  if (avcodec_parameters_to_context(c.dec, st->codecpar) < 0) return -3;
  if (avcodec_open2(c.dec, codec, nullptr) < 0) return -3;

  int nch = c.dec->ch_layout.nb_channels;
  int rate = c.dec->sample_rate;
  if (nch <= 0 || rate <= 0) return -4;
  if (swr_alloc_set_opts2(&c.swr, &c.dec->ch_layout, AV_SAMPLE_FMT_S16, rate,
                          &c.dec->ch_layout, c.dec->sample_fmt, rate, 0,
                          nullptr) < 0)
    return -5;
  if (swr_init(c.swr) < 0) return -5;

  c.pkt = av_packet_alloc();
  c.frame = av_frame_alloc();
  std::vector<int16_t> pcm;
  while (av_read_frame(c.fmt, c.pkt) >= 0) {
    if (c.pkt->stream_index == sidx) {
      if (avcodec_send_packet(c.dec, c.pkt) == 0) {
        if (drain_frames(c, pcm, nch) < 0) { av_packet_unref(c.pkt); return -6; }
      }
    }
    av_packet_unref(c.pkt);
  }
  avcodec_send_packet(c.dec, nullptr);  // flush decoder
  if (drain_frames(c, pcm, nch) < 0) return -6;
  // flush swresample's tail
  for (;;) {
    std::vector<int16_t> buf((size_t)4096 * nch);
    uint8_t* outp = (uint8_t*)buf.data();
    int got = swr_convert(c.swr, &outp, 4096, nullptr, 0);
    if (got <= 0) break;
    pcm.insert(pcm.end(), buf.begin(), buf.begin() + (size_t)got * nch);
  }
  if (pcm.empty()) return -7;

  int16_t* res = (int16_t*)malloc(pcm.size() * 2);
  if (!res) return -3;
  memcpy(res, pcm.data(), pcm.size() * 2);
  *out = res;
  *n_frames = (int64_t)(pcm.size() / nch);
  *channels = nch;
  *sample_rate = rate;
  return 0;
}

// Encode interleaved int16 PCM to `path`; container/codec guessed from
// the extension (aac/m4a -> AAC, mp3 -> libmp3lame, ogg -> vorbis...).
// `bitrate` in bits/s; <= 0 picks the 128 kb/s default. Lossless
// codecs (FLAC) ignore it. (Reference parity: the upstream encoder
// exposes a bitrate knob — SURVEY.md §2.1 encoder row.)
int xm_ff_encode(const char* path, const int16_t* pcm, int64_t n_frames,
                 int32_t channels, int32_t sample_rate, int32_t bitrate) {
  AVFormatContext* oc = nullptr;
  if (avformat_alloc_output_context2(&oc, nullptr, nullptr, path) < 0 || !oc)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(oc->oformat->audio_codec);
  if (!codec) { avformat_free_context(oc); return -2; }

  AVCodecContext* enc = avcodec_alloc_context3(codec);
  AVStream* st = avformat_new_stream(oc, nullptr);
  SwrContext* swr = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = av_packet_alloc();
  int rc = -3;

  do {
    if (!enc || !st || !pkt) break;
    enc->sample_rate = sample_rate;
    av_channel_layout_default(&enc->ch_layout, channels);
    enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0]
                                         : AV_SAMPLE_FMT_S16;
    enc->bit_rate = bitrate > 0 ? bitrate : 128000;
    enc->time_base = {1, sample_rate};
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
      enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(enc, codec, nullptr) < 0) break;
    if (avcodec_parameters_from_context(st->codecpar, enc) < 0) break;
    st->time_base = enc->time_base;

    if (swr_alloc_set_opts2(&swr, &enc->ch_layout, enc->sample_fmt,
                            sample_rate, &enc->ch_layout, AV_SAMPLE_FMT_S16,
                            sample_rate, 0, nullptr) < 0 ||
        swr_init(swr) < 0)
      break;
    if (!(oc->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&oc->pb, path, AVIO_FLAG_WRITE) < 0)
      break;
    if (avformat_write_header(oc, nullptr) < 0) break;

    int fs = enc->frame_size > 0 ? enc->frame_size : 1024;
    frame = av_frame_alloc();
    if (!frame) break;
    frame->format = enc->sample_fmt;
    av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
    frame->sample_rate = sample_rate;
    frame->nb_samples = fs;
    if (av_frame_get_buffer(frame, 0) < 0) break;

    int64_t pos = 0, pts = 0;
    bool fail = false;
    auto send_and_mux = [&](AVFrame* f) -> bool {
      if (avcodec_send_frame(enc, f) < 0) return false;
      int r;
      while ((r = avcodec_receive_packet(enc, pkt)) == 0) {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(oc, pkt) < 0) return false;
      }
      return r == AVERROR(EAGAIN) || r == AVERROR_EOF;
    };
    while (pos < n_frames && !fail) {
      int chunk = (int)((n_frames - pos) < fs ? (n_frames - pos) : fs);
      if (av_frame_make_writable(frame) < 0) { fail = true; break; }
      const uint8_t* in = (const uint8_t*)(pcm + pos * channels);
      int got = swr_convert(swr, frame->data, chunk, &in, chunk);
      if (got < 0) { fail = true; break; }
      frame->nb_samples = got;
      frame->pts = pts;
      pts += got;
      if (!send_and_mux(frame)) { fail = true; break; }
      pos += chunk;
    }
    if (!fail && send_and_mux(nullptr) && av_write_trailer(oc) == 0) rc = 0;
  } while (false);

  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (swr) swr_free(&swr);
  if (enc) avcodec_free_context(&enc);
  if (oc) {
    if (!(oc->oformat->flags & AVFMT_NOFILE) && oc->pb) avio_closep(&oc->pb);
    avformat_free_context(oc);
  }
  return rc;
}

void xm_ff_free(void* p) { free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Handle-style chunked decode: open / seek / read / close.
//
// Reference analogue: `audio_decoder_create / audio_decoder_seekTo /
// audio_decoder_get_decoded_frame / audio_decoder_freep` [upstream,
// SURVEY.md §2.1] — constant-memory streaming decode of long compressed
// files (an hour-long m4a costs one packet + one frame + a small PCM
// buffer, not the whole file; contrast xm_ff_decode above).
// ---------------------------------------------------------------------------

namespace {

struct FFHandle {
  DecodeCtx c;
  int sidx = -1;
  int nch = 0;
  int rate = 0;
  std::vector<int16_t> buf;   // decoded-but-unread interleaved PCM
  size_t buf_pos = 0;         // consumed frames * nch into buf
  int64_t next_sample = 0;    // stream position of buf's first frame
  int64_t skip_until = 0;     // post-seek: drop samples before this
  bool eof = false;

  size_t buffered_frames() const { return (buf.size() - buf_pos) / nch; }

  void compact() {
    if (buf_pos) { buf.erase(buf.begin(), buf.begin() + buf_pos); buf_pos = 0; }
  }

  // Decode packets until >= want frames buffered or EOF. Returns <0 on error.
  int fill(int64_t want) {
    while (!eof && (int64_t)buffered_frames() < want) {
      int rr = av_read_frame(c.fmt, c.pkt);
      if (rr < 0) {  // end of container: flush decoder + swr
        avcodec_send_packet(c.dec, nullptr);
        if (drain(true) < 0) return -6;
        eof = true;
        break;
      }
      if (c.pkt->stream_index == sidx) {
        if (avcodec_send_packet(c.dec, c.pkt) == 0) {
          if (drain(false) < 0) { av_packet_unref(c.pkt); return -6; }
        }
      }
      av_packet_unref(c.pkt);
    }
    return 0;
  }

  // Receive decoded frames, convert, append to buf honoring skip_until.
  int drain(bool flush) {
    int rc;
    std::vector<int16_t> tmp;  // reused scratch (see drain_frames)
    while ((rc = avcodec_receive_frame(c.dec, c.frame)) == 0) {
      if (c.frame->pts != AV_NOPTS_VALUE) {
        // trust container timestamps after a seek (sample-accurate)
        AVStream* st = c.fmt->streams[sidx];
        int64_t pos = av_rescale_q(c.frame->pts, st->time_base,
                                   AVRational{1, rate});
        if (buffered_frames() == 0) next_sample = pos;
      }
      int out_samples = swr_get_out_samples(c.swr, c.frame->nb_samples);
      tmp.resize((size_t)out_samples * nch);
      uint8_t* outp = (uint8_t*)tmp.data();
      int got = swr_convert(c.swr, &outp, out_samples,
                            (const uint8_t**)c.frame->extended_data,
                            c.frame->nb_samples);
      av_frame_unref(c.frame);
      if (got < 0) return got;
      append(tmp.data(), got);
    }
    if (flush) {  // swresample tail
      tmp.resize((size_t)4096 * nch);
      for (;;) {
        uint8_t* outp = (uint8_t*)tmp.data();
        int got = swr_convert(c.swr, &outp, 4096, nullptr, 0);
        if (got <= 0) break;
        append(tmp.data(), got);
      }
    }
    return rc == AVERROR(EAGAIN) || rc == AVERROR_EOF ? 0 : rc;
  }

  void append(const int16_t* data, int frames) {
    int64_t start = next_sample + (int64_t)buffered_frames();
    int64_t drop = skip_until > start ? skip_until - start : 0;
    if (drop >= frames) return;
    if (buffered_frames() == 0)  // first kept sample defines the position
      next_sample = start + drop;
    buf.insert(buf.end(), data + (size_t)drop * nch,
               data + (size_t)frames * nch);
  }
};

}  // namespace

extern "C" {

// -> opaque handle or NULL. duration_frames is best-effort (-1 unknown).
void* xm_ff_open(const char* path, int32_t* channels, int32_t* sample_rate,
                 int64_t* duration_frames) {
  FFHandle* h = new (std::nothrow) FFHandle();
  if (!h) return nullptr;
  DecodeCtx& c = h->c;
  const AVCodec* codec = nullptr;
  if (avformat_open_input(&c.fmt, path, nullptr, nullptr) < 0 ||
      avformat_find_stream_info(c.fmt, nullptr) < 0 ||
      (h->sidx = av_find_best_stream(c.fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                     &codec, 0)) < 0 || !codec) {
    delete h;
    return nullptr;
  }
  AVStream* st = c.fmt->streams[h->sidx];
  c.dec = avcodec_alloc_context3(codec);
  if (!c.dec || avcodec_parameters_to_context(c.dec, st->codecpar) < 0 ||
      avcodec_open2(c.dec, codec, nullptr) < 0) {
    delete h;
    return nullptr;
  }
  h->nch = c.dec->ch_layout.nb_channels;
  h->rate = c.dec->sample_rate;
  if (h->nch <= 0 || h->rate <= 0 ||
      swr_alloc_set_opts2(&c.swr, &c.dec->ch_layout, AV_SAMPLE_FMT_S16,
                          h->rate, &c.dec->ch_layout, c.dec->sample_fmt,
                          h->rate, 0, nullptr) < 0 ||
      swr_init(c.swr) < 0) {
    delete h;
    return nullptr;
  }
  c.pkt = av_packet_alloc();
  c.frame = av_frame_alloc();
  *channels = h->nch;
  *sample_rate = h->rate;
  int64_t dur = -1;
  if (st->duration != AV_NOPTS_VALUE)
    dur = av_rescale_q(st->duration, st->time_base, AVRational{1, h->rate});
  else if (c.fmt->duration != AV_NOPTS_VALUE)
    dur = c.fmt->duration * h->rate / AV_TIME_BASE;
  *duration_frames = dur;
  return h;
}

// Read up to max_frames interleaved frames. -> frames read (0 = EOF, <0 err).
int64_t xm_ff_read(void* hp, int16_t* out, int64_t max_frames) {
  FFHandle* h = (FFHandle*)hp;
  if (h->fill(max_frames) < 0) return -1;
  int64_t avail = (int64_t)h->buffered_frames();
  int64_t take = avail < max_frames ? avail : max_frames;
  memcpy(out, h->buf.data() + h->buf_pos, (size_t)take * h->nch * 2);
  h->buf_pos += (size_t)take * h->nch;
  h->next_sample += take;
  h->compact();
  return take;
}

// Seek to an absolute sample position (container seek to the preceding
// keyframe, then decode-and-drop to the exact sample).
int xm_ff_seek(void* hp, int64_t sample_pos) {
  FFHandle* h = (FFHandle*)hp;
  AVStream* st = h->c.fmt->streams[h->sidx];
  int64_t ts = av_rescale_q(sample_pos, AVRational{1, h->rate},
                            st->time_base);
  if (av_seek_frame(h->c.fmt, h->sidx, ts, AVSEEK_FLAG_BACKWARD) < 0)
    return -1;
  avcodec_flush_buffers(h->c.dec);
  h->buf.clear();
  h->buf_pos = 0;
  h->eof = false;
  h->next_sample = sample_pos;  // corrected by the first pts seen
  h->skip_until = sample_pos;
  return 0;
}

// Currently buffered (decoded, unread) frames — lets callers assert the
// constant-memory property.
int64_t xm_ff_buffered(void* hp) {
  return (int64_t)((FFHandle*)hp)->buffered_frames();
}

void xm_ff_close(void* hp) { delete (FFHandle*)hp; }

}  // extern "C"
