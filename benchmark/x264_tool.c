/* Encodes raw frames with libx264 through libavcodec, or decodes an
 * Annex-B H.264 stream with libavcodec's own decoder.
 *
 *   x264_tool enc W H FPS BITRATE MAXRATE BUFSIZE LEVEL X264PARAMS
 *       stdin: yuv420p frames, W x H; stdout: the Annex-B stream.
 *       preset medium, profile high, one thread, every other setting
 *       at the preset's default unless X264PARAMS names it.
 *   x264_tool dec
 *       stdin: an Annex-B stream; stdout: each decoded picture, in
 *       output order, as cropped yuv420p planes.
 *   x264_tool version
 *       prints libavcodec's version and x264's build number.
 *
 * Built by make_x264_streams.py with
 *   gcc -O2 x264_tool.c -o x264_tool -lavcodec -lavutil
 * and run only when streams are made; no benchmark run needs it.
 */
#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static int die(const char *what, int err) {
    char buf[128];
    av_strerror(err, buf, sizeof buf);
    fprintf(stderr, "x264_tool: %s: %s\n", what, buf);
    return 1;
}

static int drain_packets(AVCodecContext *c, AVPacket *pkt) {
    int r;
    while ((r = avcodec_receive_packet(c, pkt)) == 0) {
        fwrite(pkt->data, 1, pkt->size, stdout);
        av_packet_unref(pkt);
    }
    return r == AVERROR(EAGAIN) || r == AVERROR_EOF ? 0 : r;
}

static int encode(char **a) {
    int w = atoi(a[0]), h = atoi(a[1]), fps = atoi(a[2]);
    const AVCodec *codec = avcodec_find_encoder_by_name("libx264");
    if (!codec) return die("no libx264 encoder", AVERROR_ENCODER_NOT_FOUND);
    AVCodecContext *c = avcodec_alloc_context3(codec);
    c->width = w;
    c->height = h;
    c->time_base = (AVRational){1, fps};
    c->framerate = (AVRational){fps, 1};
    c->pix_fmt = AV_PIX_FMT_YUV420P;
    c->bit_rate = atol(a[3]);
    c->rc_max_rate = atol(a[4]);
    c->rc_buffer_size = atoi(a[5]);
    c->level = atoi(a[6]);
    c->thread_count = 1;
    AVDictionary *opt = NULL;
    av_dict_set(&opt, "preset", "medium", 0);
    av_dict_set(&opt, "profile", "high", 0);
    av_dict_set(&opt, "x264-params", a[7], 0);
    int r = avcodec_open2(c, codec, &opt);
    if (r < 0) return die("avcodec_open2", r);
    AVFrame *f = av_frame_alloc();
    f->format = c->pix_fmt;
    f->width = w;
    f->height = h;
    if ((r = av_frame_get_buffer(f, 0)) < 0) return die("frame", r);
    AVPacket *pkt = av_packet_alloc();
    size_t n = (size_t)w * h * 3 / 2;
    unsigned char *buf = malloc(n);
    for (int64_t pts = 0; fread(buf, 1, n, stdin) == n; pts++) {
        av_frame_make_writable(f);
        av_image_copy_plane(f->data[0], f->linesize[0], buf, w, w, h);
        av_image_copy_plane(f->data[1], f->linesize[1], buf + w * h, w / 2,
                            w / 2, h / 2);
        av_image_copy_plane(f->data[2], f->linesize[2],
                            buf + w * h + w * h / 4, w / 2, w / 2, h / 2);
        f->pts = pts;
        if ((r = avcodec_send_frame(c, f)) < 0) return die("send", r);
        if ((r = drain_packets(c, pkt)) < 0) return die("receive", r);
    }
    avcodec_send_frame(c, NULL);
    if ((r = drain_packets(c, pkt)) < 0) return die("flush", r);
    free(buf);
    av_packet_free(&pkt);
    av_frame_free(&f);
    avcodec_free_context(&c);
    return 0;
}

static int drain_frames(AVCodecContext *c, AVFrame *f) {
    int r;
    while ((r = avcodec_receive_frame(c, f)) == 0) {
        for (int p = 0; p < 3; p++) {
            int pw = p ? f->width / 2 : f->width;
            int ph = p ? f->height / 2 : f->height;
            for (int y = 0; y < ph; y++)
                fwrite(f->data[p] + (size_t)y * f->linesize[p], 1, pw,
                       stdout);
        }
        av_frame_unref(f);
    }
    return r == AVERROR(EAGAIN) || r == AVERROR_EOF ? 0 : r;
}

static int decode(void) {
    const AVCodec *codec = avcodec_find_decoder(AV_CODEC_ID_H264);
    AVCodecParserContext *parser = av_parser_init(AV_CODEC_ID_H264);
    AVCodecContext *c = avcodec_alloc_context3(codec);
    c->thread_count = 1;
    int r = avcodec_open2(c, codec, NULL);
    if (r < 0) return die("avcodec_open2", r);
    AVPacket *pkt = av_packet_alloc();
    AVFrame *f = av_frame_alloc();
    static unsigned char in[1 << 16];
    size_t got;
    int eof = 0;
    while (!eof) {
        got = fread(in, 1, sizeof in, stdin);
        eof = got == 0;
        unsigned char *p = in;
        do {
            int used = av_parser_parse2(parser, c, &pkt->data, &pkt->size,
                                        p, (int)got, AV_NOPTS_VALUE,
                                        AV_NOPTS_VALUE, 0);
            p += used;
            got -= used;
            if (pkt->size) {
                if ((r = avcodec_send_packet(c, pkt)) < 0)
                    return die("send", r);
                if ((r = drain_frames(c, f)) < 0) return die("receive", r);
            }
        } while (got > 0);
    }
    avcodec_send_packet(c, NULL);
    if ((r = drain_frames(c, f)) < 0) return die("flush", r);
    av_parser_close(parser);
    av_packet_free(&pkt);
    av_frame_free(&f);
    avcodec_free_context(&c);
    return 0;
}

int main(int argc, char **argv) {
    if (argc == 10 && !strcmp(argv[1], "enc")) return encode(argv + 2);
    if (argc == 2 && !strcmp(argv[1], "dec")) return decode();
    if (argc == 2 && !strcmp(argv[1], "version")) {
        const AVCodec *x = avcodec_find_encoder_by_name("libx264");
        printf("libavcodec %s; %s\n", AV_STRINGIFY(LIBAVCODEC_VERSION),
               x ? x->long_name : "no libx264");
        return 0;
    }
    fprintf(stderr, "usage: x264_tool enc W H FPS BITRATE MAXRATE BUFSIZE "
                    "LEVEL X264PARAMS | dec | version\n");
    return 2;
}
