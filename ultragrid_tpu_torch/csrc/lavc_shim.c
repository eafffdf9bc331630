/* Flat-ABI shim over libavcodec/libswscale for ctypes loading.
 *
 * Role analogue of the reference's libavcodec compress/decompress modules
 * (src/video_compress/libavcodec.cpp, src/video_decompress/libavcodec.c) and
 * its lavc pixfmt glue (src/libavcodec/*) — the reference links the same
 * system library; this shim exposes a minimal open/encode/decode/close
 * surface so Python never touches version-specific struct layouts.
 * Original code.
 *
 * The PyTorch port's copy of native/lavc_shim.c, with the decoder's fault
 * F1 repaired: one decoding thread (frame threads hold frames back and the
 * shared shim never drains them), a packet refused with EAGAIN is resent
 * after its pending frame is taken, and lavc_dec_flush drains the frames a
 * reordering stream (B-frames) still holds at its end.
 *
 * Build: cc -O2 -fPIC -shared lavc_shim.c -o lavc_shim.so \
 *        -lavcodec -lavutil -lswscale
 */

#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* capability probing                                                   */

int lavc_version(void) { return avcodec_version(); }

int lavc_have(const char *name, int encoder)
{
    return (encoder ? avcodec_find_encoder_by_name(name)
                    : avcodec_find_decoder_by_name(name)) != NULL;
}

/* list codec names (encoders if encoder!=0) into buf, newline separated */
long lavc_list(int encoder, char *buf, long cap)
{
    void *iter = NULL;
    const AVCodec *c;
    long off = 0;
    while ((c = av_codec_iterate(&iter)) != NULL) {
        if ((encoder && !av_codec_is_encoder(c)) ||
            (!encoder && !av_codec_is_decoder(c)))
            continue;
        long n = (long)strlen(c->name);
        if (off + n + 1 >= cap)
            break;
        memcpy(buf + off, c->name, (size_t)n);
        buf[off + n] = '\n';
        off += n + 1;
    }
    return off;
}

/* ------------------------------------------------------------------ */
/* video encoder                                                        */

typedef struct {
    AVCodecContext *ctx;
    AVFrame *frame;
    AVPacket *pkt;
    struct SwsContext *sws;    /* input conversion when needed */
    enum AVPixelFormat in_fmt; /* caller's pixel format */
    int w, h;
    long pts;
} VEnc;

/* in_fmt: 0=UYVY422 1=RGB24 2=YUV420P 3=YUYV422 4=RGBA */
static enum AVPixelFormat map_fmt(int f)
{
    switch (f) {
    case 0: return AV_PIX_FMT_UYVY422;
    case 1: return AV_PIX_FMT_RGB24;
    case 2: return AV_PIX_FMT_YUV420P;
    case 3: return AV_PIX_FMT_YUYV422;
    case 4: return AV_PIX_FMT_RGBA;
    default: return AV_PIX_FMT_NONE;
    }
}

static int fmt_supported(const AVCodec *codec, enum AVPixelFormat fmt)
{
    if (codec->pix_fmts == NULL)
        return 1;
    for (const enum AVPixelFormat *p = codec->pix_fmts; *p != AV_PIX_FMT_NONE; p++)
        if (*p == fmt)
            return 1;
    return 0;
}

void *lavc_enc_open(const char *codec_name, int w, int h, int in_fmt_i,
                    int fps, long bitrate, const char *opts)
{
    const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
    if (codec == NULL)
        return NULL;
    VEnc *e = av_mallocz(sizeof(VEnc));
    e->ctx = avcodec_alloc_context3(codec);
    e->w = w;
    e->h = h;
    e->in_fmt = map_fmt(in_fmt_i);
    e->ctx->width = w;
    e->ctx->height = h;
    e->ctx->time_base = (AVRational){1, fps > 0 ? fps : 30};
    e->ctx->framerate = (AVRational){fps > 0 ? fps : 30, 1};
    e->ctx->bit_rate = bitrate;
    e->ctx->gop_size = 12;
    e->ctx->max_b_frames = 0; /* low latency like the reference defaults */
    e->ctx->thread_count = 1;
    enum AVPixelFormat enc_fmt =
        fmt_supported(codec, e->in_fmt) ? e->in_fmt : AV_PIX_FMT_YUV420P;
    if (!fmt_supported(codec, enc_fmt) && codec->pix_fmts)
        enc_fmt = codec->pix_fmts[0];
    e->ctx->pix_fmt = enc_fmt;
    e->ctx->strict_std_compliance = FF_COMPLIANCE_UNOFFICIAL; /* mjpeg yuv422p */
    if (codec->id == AV_CODEC_ID_FFV1)
        /* FFV1's configuration record lives in extradata; the decoder will
         * not open without it (fetched via lavc_enc_extradata) */
        e->ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    /* parse "key=value:key=value" options */
    if (opts && opts[0]) {
        char tmp[512];
        snprintf(tmp, sizeof tmp, "%s", opts);
        char *save = NULL;
        for (char *tok = strtok_r(tmp, ":", &save); tok;
             tok = strtok_r(NULL, ":", &save)) {
            char *eq = strchr(tok, '=');
            if (eq) {
                *eq = 0;
                av_opt_set(e->ctx->priv_data, tok, eq + 1, 0);
                av_opt_set(e->ctx, tok, eq + 1, 0);
            }
        }
    }
    if (avcodec_open2(e->ctx, codec, NULL) < 0) {
        avcodec_free_context(&e->ctx);
        av_free(e);
        return NULL;
    }
    e->frame = av_frame_alloc();
    e->frame->format = enc_fmt;
    e->frame->width = w;
    e->frame->height = h;
    av_frame_get_buffer(e->frame, 0);
    e->pkt = av_packet_alloc();
    if (enc_fmt != e->in_fmt)
        e->sws = sws_getContext(w, h, e->in_fmt, w, h, enc_fmt,
                                SWS_FAST_BILINEAR, NULL, NULL, NULL);
    return e;
}

/* Encode one packed frame (single plane, in_fmt layout). Returns packet
 * size written to out (or 0 if the encoder buffered it, <0 on error).
 * keyframe_out receives 1 when the packet is a keyframe. */
long lavc_enc_frame(void *ve, const unsigned char *data, long linesize,
                    int force_key, unsigned char *out, long cap,
                    int *keyframe_out)
{
    VEnc *e = ve;
    av_frame_make_writable(e->frame);
    const uint8_t *src_planes[4] = {data, NULL, NULL, NULL};
    int src_ls[4] = {(int)linesize, 0, 0, 0};
    if (e->in_fmt == AV_PIX_FMT_YUV420P) {
        src_planes[1] = data + (long)linesize * e->h;
        src_planes[2] = src_planes[1] + (long)(linesize / 2) * (e->h / 2);
        src_ls[1] = src_ls[2] = (int)linesize / 2;
    }
    if (e->sws != NULL) {
        sws_scale(e->sws, src_planes, src_ls, 0, e->h, e->frame->data,
                  e->frame->linesize);
    } else {
        av_image_copy(e->frame->data, e->frame->linesize, src_planes, src_ls,
                      e->ctx->pix_fmt, e->w, e->h);
    }
    e->frame->pts = e->pts++;
    e->frame->pict_type = force_key ? AV_PICTURE_TYPE_I : AV_PICTURE_TYPE_NONE;
    if (avcodec_send_frame(e->ctx, e->frame) < 0)
        return -1;
    long total = 0;
    int key = 0;
    for (;;) {
        int r = avcodec_receive_packet(e->ctx, e->pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF)
            break;
        if (r < 0)
            return -1;
        if (total + e->pkt->size <= cap) {
            memcpy(out + total, e->pkt->data, (size_t)e->pkt->size);
            total += e->pkt->size;
        }
        key |= (e->pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
        av_packet_unref(e->pkt);
    }
    if (keyframe_out)
        *keyframe_out = key;
    return total;
}

/* Copy the encoder's extradata (FFV1 configuration record etc.) to out. */
long lavc_enc_extradata(void *ve, unsigned char *out, long cap)
{
    VEnc *e = ve;
    if (e->ctx->extradata == NULL || e->ctx->extradata_size > cap)
        return 0;
    memcpy(out, e->ctx->extradata, (size_t)e->ctx->extradata_size);
    return e->ctx->extradata_size;
}

void lavc_enc_close(void *ve)
{
    VEnc *e = ve;
    if (!e)
        return;
    avcodec_free_context(&e->ctx);
    av_frame_free(&e->frame);
    av_packet_free(&e->pkt);
    if (e->sws)
        sws_freeContext(e->sws);
    av_free(e);
}

/* ------------------------------------------------------------------ */
/* video decoder                                                        */

typedef struct {
    AVCodecContext *ctx;
    AVFrame *frame;
    AVPacket *pkt;
    struct SwsContext *sws;
    int out_fmt_i;
    int sws_w, sws_h;
    enum AVPixelFormat sws_src;
    int draining;
} VDec;

void *lavc_dec_open2(const char *codec_name, const unsigned char *extradata,
                     long ed_size, int w, int h)
{
    const AVCodec *codec = avcodec_find_decoder_by_name(codec_name);
    if (codec == NULL)
        return NULL;
    VDec *d = av_mallocz(sizeof(VDec));
    d->ctx = avcodec_alloc_context3(codec);
    d->ctx->thread_count = 1; /* frame threads delay every output */
    d->ctx->width = w;  /* some decoders (ffv1) need dims at open */
    d->ctx->height = h;
    if (extradata != NULL && ed_size > 0) {
        d->ctx->extradata =
            av_mallocz((size_t)ed_size + AV_INPUT_BUFFER_PADDING_SIZE);
        memcpy(d->ctx->extradata, extradata, (size_t)ed_size);
        d->ctx->extradata_size = (int)ed_size;
    }
    if (avcodec_open2(d->ctx, codec, NULL) < 0) {
        avcodec_free_context(&d->ctx);
        av_free(d);
        return NULL;
    }
    d->frame = av_frame_alloc();
    d->pkt = av_packet_alloc();
    return d;
}

void *lavc_dec_open(const char *codec_name)
{
    return lavc_dec_open2(codec_name, NULL, 0, 0, 0);
}

/* Convert the decoded frame in d->frame to out_fmt (map_fmt) packed into
 * out.  Returns bytes written (w*h*bpp), -2 when cap is too small. */
static long dec_convert(VDec *d, int out_fmt_i, unsigned char *out, long cap,
                        int *wh_out)
{
    int w = d->frame->width, h = d->frame->height;
    if (wh_out) {
        wh_out[0] = w;
        wh_out[1] = h;
    }
    enum AVPixelFormat ofmt = map_fmt(out_fmt_i);
    int obpp = (ofmt == AV_PIX_FMT_RGB24) ? 3 : (ofmt == AV_PIX_FMT_RGBA) ? 4 : 2;
    long need = (long)w * h * obpp;
    if (need > cap)
        return -2;
    if (d->sws == NULL || d->sws_w != w || d->sws_h != h ||
        d->sws_src != d->frame->format || d->out_fmt_i != out_fmt_i) {
        if (d->sws)
            sws_freeContext(d->sws);
        d->sws = sws_getContext(w, h, d->frame->format, w, h, ofmt,
                                SWS_FAST_BILINEAR, NULL, NULL, NULL);
        d->sws_w = w;
        d->sws_h = h;
        d->sws_src = d->frame->format;
        d->out_fmt_i = out_fmt_i;
        /* preserve the stream's sample range: JPEG/full-range sources must
         * not get squeezed to limited range on the way to UYVY (UltraGrid
         * hands codec samples through unchanged) */
        int src_range = d->frame->color_range == AVCOL_RANGE_JPEG ? 1 : 0;
        int *inv_tbl, *tbl, sr, dr, br, co, sa;
        if (sws_getColorspaceDetails(d->sws, &inv_tbl, &sr, &tbl, &dr, &br,
                                     &co, &sa) >= 0)
            sws_setColorspaceDetails(d->sws, inv_tbl, src_range, tbl,
                                     src_range, br, co, sa);
    }
    uint8_t *dst[4] = {out, NULL, NULL, NULL};
    int dls[4] = {w * obpp, 0, 0, 0};
    sws_scale(d->sws, (const uint8_t *const *)d->frame->data,
              d->frame->linesize, 0, h, dst, dls);
    av_frame_unref(d->frame);
    return need;
}

/* Decode one packet; convert to out_fmt (map_fmt) packed into out.
 * Returns bytes written (w*h*bpp), 0 if no frame yet, <0 on error.
 * wh_out[0..1] receive width/height.  A packet the decoder refuses with
 * EAGAIN (its output is full) is sent again once the pending frame has been
 * taken, so no packet is dropped. */
long lavc_dec_packet(void *vd, const unsigned char *data, long size,
                     int out_fmt_i, unsigned char *out, long cap, int *wh_out)
{
    VDec *d = vd;
    av_packet_unref(d->pkt);
    if (av_new_packet(d->pkt, (int)size) < 0)
        return -1;
    memcpy(d->pkt->data, data, (size_t)size);
    int s = avcodec_send_packet(d->ctx, d->pkt);
    if (s < 0 && s != AVERROR(EAGAIN))
        return -1;
    int r = avcodec_receive_frame(d->ctx, d->frame);
    if (s == AVERROR(EAGAIN) && avcodec_send_packet(d->ctx, d->pkt) < 0) {
        if (r == 0)
            av_frame_unref(d->frame);
        return -1;
    }
    if (r == AVERROR(EAGAIN))
        return 0;
    if (r < 0)
        return -1;
    return dec_convert(d, out_fmt_i, out, cap, wh_out);
}

/* End of stream: the next frame the decoder still holds (reordering delay),
 * converted as by lavc_dec_packet.  Returns bytes written, 0 when every
 * frame has been taken, <0 on error.  The first call enters draining mode;
 * call until it returns 0. */
long lavc_dec_flush(void *vd, int out_fmt_i, unsigned char *out, long cap,
                    int *wh_out)
{
    VDec *d = vd;
    if (!d->draining) {
        d->draining = 1;
        if (avcodec_send_packet(d->ctx, NULL) < 0)
            return -1;
    }
    int r = avcodec_receive_frame(d->ctx, d->frame);
    if (r == AVERROR_EOF || r == AVERROR(EAGAIN))
        return 0;
    if (r < 0)
        return -1;
    return dec_convert(d, out_fmt_i, out, cap, wh_out);
}

void lavc_dec_close(void *vd)
{
    VDec *d = vd;
    if (!d)
        return;
    avcodec_free_context(&d->ctx);
    av_frame_free(&d->frame);
    av_packet_free(&d->pkt);
    if (d->sws)
        sws_freeContext(d->sws);
    av_free(d);
}

/* ------------------------------------------------------------------ */
/* audio codec (interleaved s16 in/out)                                 */

typedef struct {
    AVCodecContext *ctx;
    AVFrame *frame;
    AVPacket *pkt;
    long pts;
} ACod;

void *lavc_aenc_open(const char *codec_name, int sample_rate, int channels,
                     long bitrate, const char *opts)
{
    const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
    if (codec == NULL)
        return NULL;
    ACod *a = av_mallocz(sizeof(ACod));
    a->ctx = avcodec_alloc_context3(codec);
    a->ctx->sample_rate = sample_rate;
    av_channel_layout_default(&a->ctx->ch_layout, channels);
    a->ctx->sample_fmt = AV_SAMPLE_FMT_S16;
    if (codec->sample_fmts) {
        int ok = 0;
        for (const enum AVSampleFormat *f = codec->sample_fmts;
             *f != AV_SAMPLE_FMT_NONE; f++)
            if (*f == AV_SAMPLE_FMT_S16)
                ok = 1;
        if (!ok)
            a->ctx->sample_fmt = codec->sample_fmts[0];
    }
    a->ctx->bit_rate = bitrate;
    a->ctx->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
    if (opts && opts[0]) {
        char tmp[256];
        snprintf(tmp, sizeof tmp, "%s", opts);
        char *save = NULL;
        for (char *tok = strtok_r(tmp, ":", &save); tok;
             tok = strtok_r(NULL, ":", &save)) {
            char *eq = strchr(tok, '=');
            if (eq) {
                *eq = 0;
                av_opt_set(a->ctx->priv_data, tok, eq + 1, 0);
                av_opt_set(a->ctx, tok, eq + 1, 0);
            }
        }
    }
    if (avcodec_open2(a->ctx, codec, NULL) < 0) {
        avcodec_free_context(&a->ctx);
        av_free(a);
        return NULL;
    }
    a->frame = av_frame_alloc();
    a->pkt = av_packet_alloc();
    return a;
}

int lavc_aenc_frame_size(void *va)
{
    ACod *a = va;
    return a->ctx->frame_size; /* 0 = encoder accepts any count */
}

/* samples: interleaved s16, exactly frame_size per channel.  Returns bytes
 * written to out across any packets produced. */
long lavc_aenc_encode(void *va, const short *samples, int nsamples,
                      unsigned char *out, long cap)
{
    ACod *a = va;
    a->frame->nb_samples = nsamples;
    a->frame->format = a->ctx->sample_fmt;
    av_channel_layout_copy(&a->frame->ch_layout, &a->ctx->ch_layout);
    if (av_frame_get_buffer(a->frame, 0) < 0)
        return -1;
    int ch = a->ctx->ch_layout.nb_channels;
    if (a->ctx->sample_fmt == AV_SAMPLE_FMT_S16) {
        memcpy(a->frame->data[0], samples, (size_t)nsamples * ch * 2);
    } else if (a->ctx->sample_fmt == AV_SAMPLE_FMT_S16P) {
        for (int c = 0; c < ch; c++) {
            short *dst = (short *)a->frame->data[c];
            for (int i = 0; i < nsamples; i++)
                dst[i] = samples[i * ch + c];
        }
    } else if (a->ctx->sample_fmt == AV_SAMPLE_FMT_FLT ||
               a->ctx->sample_fmt == AV_SAMPLE_FMT_FLTP) {
        int planar = a->ctx->sample_fmt == AV_SAMPLE_FMT_FLTP;
        for (int c = 0; c < ch; c++) {
            float *dst = (float *)a->frame->data[planar ? c : 0];
            for (int i = 0; i < nsamples; i++) {
                float v = samples[i * ch + c] / 32768.0f;
                if (planar)
                    dst[i] = v;
                else
                    dst[i * ch + c] = v;
            }
        }
    } else {
        return -3;
    }
    a->frame->pts = a->pts;
    a->pts += nsamples;
    if (avcodec_send_frame(a->ctx, a->frame) < 0)
        return -1;
    av_frame_unref(a->frame);
    long total = 0;
    for (;;) {
        int r = avcodec_receive_packet(a->ctx, a->pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF)
            break;
        if (r < 0)
            return -1;
        if (total + a->pkt->size <= cap) {
            memcpy(out + total, a->pkt->data, (size_t)a->pkt->size);
            total += a->pkt->size;
        }
        av_packet_unref(a->pkt);
    }
    return total;
}

void *lavc_adec_open(const char *codec_name, int sample_rate, int channels)
{
    const AVCodec *codec = avcodec_find_decoder_by_name(codec_name);
    if (codec == NULL)
        return NULL;
    ACod *a = av_mallocz(sizeof(ACod));
    a->ctx = avcodec_alloc_context3(codec);
    a->ctx->sample_rate = sample_rate;
    av_channel_layout_default(&a->ctx->ch_layout, channels);
    if (avcodec_open2(a->ctx, codec, NULL) < 0) {
        avcodec_free_context(&a->ctx);
        av_free(a);
        return NULL;
    }
    a->frame = av_frame_alloc();
    a->pkt = av_packet_alloc();
    return a;
}

/* Returns SAMPLES per channel written to out (interleaved s16), <0 error. */
long lavc_adec_decode(void *va, const unsigned char *data, long size,
                      short *out, long cap_samples)
{
    ACod *a = va;
    av_packet_unref(a->pkt);
    av_new_packet(a->pkt, (int)size);
    memcpy(a->pkt->data, data, (size_t)size);
    if (avcodec_send_packet(a->ctx, a->pkt) < 0)
        return -1;
    long total = 0;
    for (;;) {
        int r = avcodec_receive_frame(a->ctx, a->frame);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF)
            break;
        if (r < 0)
            return -1;
        int ch = a->ctx->ch_layout.nb_channels;
        int ns = a->frame->nb_samples;
        if ((total + ns) * ch > cap_samples)
            break;
        enum AVSampleFormat f = a->frame->format;
        for (int i = 0; i < ns; i++) {
            for (int c = 0; c < ch; c++) {
                short v = 0;
                if (f == AV_SAMPLE_FMT_S16)
                    v = ((short *)a->frame->data[0])[i * ch + c];
                else if (f == AV_SAMPLE_FMT_S16P)
                    v = ((short *)a->frame->data[c])[i];
                else if (f == AV_SAMPLE_FMT_FLTP) {
                    float x = ((float *)a->frame->data[c])[i] * 32768.0f;
                    v = x > 32767 ? 32767 : x < -32768 ? -32768 : (short)x;
                } else if (f == AV_SAMPLE_FMT_FLT) {
                    float x = ((float *)a->frame->data[0])[i * ch + c] * 32768.0f;
                    v = x > 32767 ? 32767 : x < -32768 ? -32768 : (short)x;
                }
                out[(total + i) * ch + c] = v;
            }
        }
        total += ns;
        av_frame_unref(a->frame);
    }
    return total;
}

void lavc_acod_close(void *va)
{
    ACod *a = va;
    if (!a)
        return;
    avcodec_free_context(&a->ctx);
    av_frame_free(&a->frame);
    av_packet_free(&a->pkt);
    av_free(a);
}

/* ------------------------------------------------------------------ */
/* libavformat demux + decode (file capture; ref: src/video_capture/file.c) */

#include <libavformat/avformat.h>

typedef struct {
    AVFormatContext *fmt;
    AVCodecContext *dec;
    AVPacket *pkt;
    AVFrame *frame;
    struct SwsContext *sws;
    int vstream;
    int w, h;
    double fps;
    enum AVPixelFormat sws_src;
    int sws_ofmt;
} LavfIn;

void *lavf_open(const char *path)
{
    LavfIn *f = av_mallocz(sizeof(LavfIn));
    if (avformat_open_input(&f->fmt, path, NULL, NULL) < 0) {
        av_free(f);
        return NULL;
    }
    if (avformat_find_stream_info(f->fmt, NULL) < 0)
        goto fail;
    f->vstream = av_find_best_stream(f->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, NULL, 0);
    if (f->vstream < 0)
        goto fail;
    AVStream *st = f->fmt->streams[f->vstream];
    const AVCodec *codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (codec == NULL)
        goto fail;
    f->dec = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(f->dec, st->codecpar);
    if (avcodec_open2(f->dec, codec, NULL) < 0)
        goto fail;
    f->w = st->codecpar->width;
    f->h = st->codecpar->height;
    AVRational fr = av_guess_frame_rate(f->fmt, st, NULL);
    f->fps = fr.den ? (double)fr.num / fr.den : 30.0;
    f->pkt = av_packet_alloc();
    f->frame = av_frame_alloc();
    return f;
fail:
    if (f->dec)
        avcodec_free_context(&f->dec);
    avformat_close_input(&f->fmt);
    av_free(f);
    return NULL;
}

int lavf_info(void *vf, int *w, int *h, double *fps)
{
    LavfIn *f = vf;
    *w = f->w;
    *h = f->h;
    *fps = f->fps;
    return 0;
}

/* Read + decode the next video frame, converted to out_fmt (map_fmt).
 * Returns bytes written, 0 at EOF, <0 on error. */
long lavf_read_frame(void *vf, int out_fmt_i, unsigned char *out, long cap)
{
    LavfIn *f = vf;
    enum AVPixelFormat ofmt = map_fmt(out_fmt_i);
    int obpp = (ofmt == AV_PIX_FMT_RGB24) ? 3 : (ofmt == AV_PIX_FMT_RGBA) ? 4 : 2;
    for (;;) {
        int r = avcodec_receive_frame(f->dec, f->frame);
        if (r == 0)
            break;
        if (r != AVERROR(EAGAIN) && r != AVERROR_EOF)
            return -1;
        r = av_read_frame(f->fmt, f->pkt);
        if (r < 0) {
            /* flush */
            avcodec_send_packet(f->dec, NULL);
            if (avcodec_receive_frame(f->dec, f->frame) == 0)
                break;
            return 0; /* EOF */
        }
        if (f->pkt->stream_index == f->vstream)
            avcodec_send_packet(f->dec, f->pkt);
        av_packet_unref(f->pkt);
    }
    int w = f->frame->width, h = f->frame->height;
    long need = (long)w * h * obpp;
    if (need > cap)
        return -2;
    if (f->sws == NULL || f->sws_src != f->frame->format || f->sws_ofmt != out_fmt_i) {
        if (f->sws)
            sws_freeContext(f->sws);
        f->sws = sws_getContext(w, h, f->frame->format, w, h, ofmt,
                                SWS_FAST_BILINEAR, NULL, NULL, NULL);
        f->sws_src = f->frame->format;
        f->sws_ofmt = out_fmt_i;
        int src_range = f->frame->color_range == AVCOL_RANGE_JPEG ? 1 : 0;
        int *inv_tbl, *tbl, sr, dr, br, co, sa;
        if (sws_getColorspaceDetails(f->sws, &inv_tbl, &sr, &tbl, &dr, &br,
                                     &co, &sa) >= 0)
            sws_setColorspaceDetails(f->sws, inv_tbl, src_range, tbl,
                                     src_range, br, co, sa);
    }
    uint8_t *dst[4] = {out, NULL, NULL, NULL};
    int dls[4] = {w * obpp, 0, 0, 0};
    sws_scale(f->sws, (const uint8_t *const *)f->frame->data,
              f->frame->linesize, 0, h, dst, dls);
    av_frame_unref(f->frame);
    return need;
}

int lavf_seek_start(void *vf)
{
    LavfIn *f = vf;
    int r = av_seek_frame(f->fmt, f->vstream, 0, AVSEEK_FLAG_BACKWARD);
    avcodec_flush_buffers(f->dec);
    return r;
}

void lavf_close(void *vf)
{
    LavfIn *f = vf;
    if (!f)
        return;
    avcodec_free_context(&f->dec);
    avformat_close_input(&f->fmt);
    av_packet_free(&f->pkt);
    av_frame_free(&f->frame);
    if (f->sws)
        sws_freeContext(f->sws);
    av_free(f);
}

/* ------------------------------------------------------------------ */
/* MPEG-TS mux over UDP (ref: src/rxtx/mpegts.c — the reference also
 * drives libavformat's mpegts muxer; pre-encoded packets are stream-copied) */

typedef struct {
    AVFormatContext *fmt;
    AVStream *st;
    AVPacket *pkt;
    long pts;
    int fps;
} LavfOut;

/* codec_id: 0=h264 1=hevc 2=mpeg2 */
void *lavf_mux_open(const char *url, int codec_id, int w, int h, int fps,
                    const unsigned char *extradata, long ed_size)
{
    LavfOut *o = av_mallocz(sizeof(LavfOut));
    if (avformat_alloc_output_context2(&o->fmt, NULL, "mpegts", url) < 0) {
        av_free(o);
        return NULL;
    }
    o->st = avformat_new_stream(o->fmt, NULL);
    o->st->codecpar->codec_type = AVMEDIA_TYPE_VIDEO;
    o->st->codecpar->codec_id =
        codec_id == 0 ? AV_CODEC_ID_H264
                      : codec_id == 1 ? AV_CODEC_ID_HEVC : AV_CODEC_ID_MPEG2VIDEO;
    o->st->codecpar->width = w;
    o->st->codecpar->height = h;
    o->st->time_base = (AVRational){1, 90000};
    o->fps = fps > 0 ? fps : 30;
    if (extradata && ed_size > 0) {
        o->st->codecpar->extradata =
            av_mallocz((size_t)ed_size + AV_INPUT_BUFFER_PADDING_SIZE);
        memcpy(o->st->codecpar->extradata, extradata, (size_t)ed_size);
        o->st->codecpar->extradata_size = (int)ed_size;
    }
    if (!(o->fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&o->fmt->pb, url, AVIO_FLAG_WRITE) < 0)
        goto fail;
    if (avformat_write_header(o->fmt, NULL) < 0)
        goto fail;
    o->pkt = av_packet_alloc();
    return o;
fail:
    avformat_free_context(o->fmt);
    av_free(o);
    return NULL;
}

int lavf_mux_write(void *vo, const unsigned char *data, long size, int key)
{
    LavfOut *o = vo;
    av_new_packet(o->pkt, (int)size);
    memcpy(o->pkt->data, data, (size_t)size);
    o->pkt->pts = o->pkt->dts = o->pts;
    o->pts += 90000 / o->fps;
    o->pkt->stream_index = o->st->index;
    if (key)
        o->pkt->flags |= AV_PKT_FLAG_KEY;
    int r = av_interleaved_write_frame(o->fmt, o->pkt);
    av_packet_unref(o->pkt);
    return r;
}

void lavf_mux_close(void *vo)
{
    LavfOut *o = vo;
    if (!o)
        return;
    av_write_trailer(o->fmt);
    if (o->fmt->pb && !(o->fmt->oformat->flags & AVFMT_NOFILE))
        avio_closep(&o->fmt->pb);
    avformat_free_context(o->fmt);
    av_packet_free(&o->pkt);
    av_free(o);
}
