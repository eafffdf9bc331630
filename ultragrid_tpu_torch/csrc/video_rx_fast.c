/* Fast-path video depacketizer: recvmmsg + RTP parse + payload-header
 * parse + scatter into per-frame reassembly buffers, all in C.
 *
 * The port's copy of native/video_rx_fast.c, with one change (the repair
 * of ROADMAP F12): a datagram that starts a frame wider than the free
 * slots is not handed back.  vrx_drain() stops at it, reports NEED_CAP
 * with the frame's length, and keeps the rest of the batch; the caller
 * grows its free slots and calls again, and the batch goes on from that
 * datagram without reading the socket.  So every datagram of a frame
 * wider than the slots, the first frame's included, is scattered into a
 * slot that holds it, where the shared copy hands back the batch in which
 * such a frame first arrives and the frame shows zeros there.
 *
 * Role analogue of the reference's receive hot path (the udp_reader
 * thread net_udp.c:163-187 feeding pbuf_insert pbuf.c:438 and the
 * LINE_DECODER copy loop video_decoders.cpp:1707-1796) — there the
 * per-packet work is C/C++; a Python per-packet loop caps a single
 * core at ~60k pkts/s, which is below the 4K60 uncompressed wire rate
 * (~122k pkts/s).  Original implementation, not derived from the
 * reference sources.
 *
 * Design: the caller (Python) owns N reassembly buffers and registers
 * them into slots.  vrx_drain() receives one recvmmsg batch and, for
 * UltraGrid video payload types (PT 20 video / 22 LDGM / 27 RS),
 * copies each packet's payload into the slot buffer at the payload
 * header's frame offset, tracking received-byte intervals, M-bit and
 * newer-frame completion (pbuf.c:466 semantics) and RFC 3550 reception
 * statistics.  Everything else (RTCP-range, encrypted PTs, standards
 * payloads, CSRC/extension headers) is returned to the caller verbatim
 * for the slow path.  Frame-granularity state is exported with one
 * bulk vrx_poll() call; playout gating stays in Python where it is
 * O(frames), not O(packets).
 */

#define _GNU_SOURCE
#include <errno.h>
#include <poll.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/types.h>

#define VRX_BATCH 256
#define VRX_MAX_SLOTS 32
#define VRX_MAX_IV 64
#define VRX_MAX_SSRC 16

#define PT_VIDEO 20
#define PT_VIDEO_LDGM 22
#define PT_VIDEO_RS 27

#define RTP_HDR 12
#define VIDEO_PH 24
#define FEC_PH 20

typedef struct {
    int in_use;
    uint32_t gen;       /* bumped at activation: lets the caller spot reuse */
    uint32_t ssrc, ts;
    uint32_t substream;
    uint8_t pt;
    uint8_t mbit;       /* a marker packet arrived */
    uint8_t completed;  /* a packet of a newer frame arrived (pbuf.c:466) */
    uint8_t hdr[VIDEO_PH];
    uint64_t frame_len;
    uint8_t *buf;
    uint64_t cap;
    int n_iv;
    int iv_overflow;    /* interval table overflowed; interior gaps were
                           zero-filled and collapsed (coverage stays exact) */
    uint64_t iv[VRX_MAX_IV][2]; /* sorted disjoint [start, end) */
    double arrival;     /* caller-supplied monotonic time of first packet */
    uint64_t pkts;
    uint64_t bytes;     /* payload bytes accepted (clamped, incl. dups) */
} vrx_slot;

typedef struct {
    int in_use;
    uint32_t ssrc;
    /* RFC 3550 A.1 reception stats (mirror of the Python SourceStats) */
    uint16_t base_seq, max_seq;
    uint32_t cycles;
    uint64_t received;
    double jitter, transit;
    int have_transit;
    /* newest frame TS seen (newer-frame completion rule) */
    uint32_t last_ts;
    int have_ts;
} vrx_ssrc;

typedef struct {
    int nslots;
    uint64_t max_frame_len;
    vrx_slot slots[VRX_MAX_SLOTS];
    vrx_ssrc ssrcs[VRX_MAX_SSRC];
    unsigned char *rbuf; /* recvmmsg scratch: VRX_BATCH * slot_size */
    int rlen[VRX_BATCH]; /* the batch's datagram lengths */
    int held_i, held_n;  /* a batch held at datagram held_i of held_n (held_n 0: none) */
    long slot_size;
    uint64_t pkts_total, bytes_total;
} vrx_state;

static uint32_t be32(const unsigned char *p)
{
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | p[3];
}

void *vrx_create(long max_frame_len, long slot_size)
{
    vrx_state *st = calloc(1, sizeof(vrx_state));
    if (!st)
        return NULL;
    st->nslots = VRX_MAX_SLOTS;
    st->max_frame_len = (uint64_t)max_frame_len;
    st->slot_size = slot_size;
    st->rbuf = malloc((size_t)VRX_BATCH * (size_t)slot_size);
    if (!st->rbuf) {
        free(st);
        return NULL;
    }
    return st;
}

void vrx_destroy(void *p)
{
    vrx_state *st = p;
    if (!st)
        return;
    free(st->rbuf);
    free(st);
}

/* Attach a caller-owned buffer to a slot and reset it for reuse. */
void vrx_set_buffer(void *p, int slot, void *buf, long cap)
{
    vrx_state *st = p;
    if (slot < 0 || slot >= st->nslots)
        return;
    vrx_slot *s = &st->slots[slot];
    uint32_t gen = s->gen;
    memset(s, 0, sizeof(*s));
    s->gen = gen;
    s->buf = buf;
    s->cap = (uint64_t)cap;
}

static vrx_ssrc *get_ssrc(vrx_state *st, uint32_t ssrc)
{
    int free_i = -1;
    for (int i = 0; i < VRX_MAX_SSRC; i++) {
        if (st->ssrcs[i].in_use && st->ssrcs[i].ssrc == ssrc)
            return &st->ssrcs[i];
        if (!st->ssrcs[i].in_use && free_i < 0)
            free_i = i;
    }
    if (free_i < 0)
        return NULL;
    vrx_ssrc *sc = &st->ssrcs[free_i];
    memset(sc, 0, sizeof(*sc));
    sc->in_use = 1;
    sc->ssrc = ssrc;
    return sc;
}

static void ssrc_update(vrx_ssrc *sc, uint16_t seq, uint32_t ts, double now)
{
    if (sc->received == 0)
        sc->base_seq = sc->max_seq = seq;
    sc->received++;
    if (seq < 0x1000 && sc->max_seq > 0xF000) {
        sc->cycles += 1u << 16;
        sc->max_seq = seq;
    } else if (seq > sc->max_seq) {
        sc->max_seq = seq;
    }
    double transit = now * 90000.0 - (double)ts;
    if (sc->have_transit) {
        double d = transit - sc->transit;
        if (d < 0)
            d = -d;
        sc->jitter += (d - sc->jitter) / 16.0;
    }
    sc->transit = transit;
    sc->have_transit = 1;
}

/* Insert [a, b) into the slot's sorted disjoint interval set, merging
 * neighbours.  On table overflow: zero-fill interior gaps (so the gap
 * bytes read as zeros like a fresh buffer would) and collapse to one
 * interval — coverage stays exact, byte accounting stays in s->bytes. */
static void iv_insert(vrx_slot *s, uint64_t a, uint64_t b)
{
    if (a >= b)
        return;
    int n = s->n_iv;
    /* fast path: extend/append at the tail (in-order arrival) */
    if (n > 0 && a >= s->iv[n - 1][0]) {
        if (a <= s->iv[n - 1][1]) {
            if (b > s->iv[n - 1][1])
                s->iv[n - 1][1] = b;
            return;
        }
        if (n < VRX_MAX_IV) {
            s->iv[n][0] = a;
            s->iv[n][1] = b;
            s->n_iv = n + 1;
            return;
        }
    } else if (n == 0) {
        s->iv[0][0] = a;
        s->iv[0][1] = b;
        s->n_iv = 1;
        return;
    } else {
        /* general insertion: find position, merge overlaps */
        int i = 0;
        while (i < n && s->iv[i][1] < a)
            i++;
        if (i < n && s->iv[i][0] <= b) { /* overlaps/touches iv[i..j] */
            int j = i;
            while (j + 1 < n && s->iv[j + 1][0] <= b)
                j++;
            if (s->iv[i][0] < a)
                a = s->iv[i][0];
            if (s->iv[j][1] > b)
                b = s->iv[j][1];
            s->iv[i][0] = a;
            s->iv[i][1] = b;
            if (j > i) {
                memmove(&s->iv[i + 1], &s->iv[j + 1],
                        (size_t)(n - j - 1) * sizeof(s->iv[0]));
                s->n_iv = n - (j - i);
            }
            return;
        }
        if (n < VRX_MAX_IV) { /* disjoint: shift and insert at i */
            memmove(&s->iv[i + 1], &s->iv[i],
                    (size_t)(n - i) * sizeof(s->iv[0]));
            s->iv[i][0] = a;
            s->iv[i][1] = b;
            s->n_iv = n + 1;
            return;
        }
    }
    /* table full: compact by zero-filling interior gaps */
    for (int i = 0; i + 1 < s->n_iv; i++) {
        uint64_t g0 = s->iv[i][1], g1 = s->iv[i + 1][0];
        if (g1 > g0)
            memset(s->buf + g0, 0, (size_t)(g1 - g0));
    }
    uint64_t lo = s->iv[0][0], hi = s->iv[s->n_iv - 1][1];
    if (a < lo) {
        if (b < lo)
            memset(s->buf + b, 0, (size_t)(lo - b));
        lo = a;
    }
    if (b > hi) {
        if (a > hi)
            memset(s->buf + hi, 0, (size_t)(a - hi));
        hi = b;
    }
    s->iv[0][0] = lo;
    s->iv[0][1] = hi;
    s->n_iv = 1;
    s->iv_overflow = 1;
}

static vrx_slot *find_slot(vrx_state *st, uint32_t ssrc, uint32_t ts,
                           uint32_t sub, uint8_t pt)
{
    for (int i = 0; i < st->nslots; i++) {
        vrx_slot *s = &st->slots[i];
        if (s->in_use && s->ssrc == ssrc && s->ts == ts &&
            s->substream == sub && s->pt == pt)
            return s;
    }
    return NULL;
}

/* flags out bits */
#define VRX_F_SLOTS_FULL 1
#define VRX_F_NEED_CAP 2

/* Drain one recvmmsg batch.  Fast-PT packets are consumed into slots;
 * everything else is copied to ovf_buf rows (ovf_lens[i] = datagram
 * length).  Returns datagrams received (0 on timeout, -1 error).
 * now: caller's time.monotonic() — one stamp per batch, matching the
 * Python recv_batch path's arrival semantics.
 *
 * A datagram that needs a free slot wider than any sets NEED_CAP and
 * need_cap and holds the batch there (the return is the batch's size);
 * the next call, after the caller has grown its free slots, goes on from
 * that datagram without reading the socket and returns how many datagrams
 * of the batch it took up.  A held datagram is counted in the statistics
 * once; if it still finds no slot wide enough it is handed back. */
long vrx_drain(void *p, int fd, long timeout_us, double now,
               unsigned char *ovf_buf, long ovf_slot_size, int *ovf_lens,
               int max_ovf, int *n_ovf, int *flags, long *need_cap)
{
    vrx_state *st = p;
    *n_ovf = 0;
    *flags = 0;
    *need_cap = 0;

    int n, i0 = 0, resumed = -1;
    if (st->held_n) {
        n = st->held_n;
        i0 = resumed = st->held_i;
        st->held_n = 0;
    } else {
        struct pollfd pfd = { .fd = fd, .events = POLLIN };
        int ptimeout = timeout_us < 0 ? -1 : (int)(timeout_us / 1000);
        if (timeout_us >= 0 && ptimeout == 0 && timeout_us > 0)
            ptimeout = 1;
        int pr = poll(&pfd, 1, ptimeout);
        if (pr <= 0)
            return pr < 0 ? -1 : 0;

        struct mmsghdr msgs[VRX_BATCH];
        struct iovec iovs[VRX_BATCH];
        memset(msgs, 0, sizeof(msgs));
        for (int i = 0; i < VRX_BATCH; i++) {
            iovs[i].iov_base = st->rbuf + (long)i * st->slot_size;
            iovs[i].iov_len = (size_t)st->slot_size;
            msgs[i].msg_hdr.msg_iov = &iovs[i];
            msgs[i].msg_hdr.msg_iovlen = 1;
        }
        n = recvmmsg(fd, msgs, VRX_BATCH, MSG_DONTWAIT, NULL);
        if (n < 0)
            return (errno == EAGAIN || errno == EWOULDBLOCK) ? 0 : -1;
        for (int i = 0; i < n; i++)
            st->rlen[i] = (int)msgs[i].msg_len;
    }

    for (int i = i0; i < n; i++) {
        const unsigned char *d = st->rbuf + (long)i * st->slot_size;
        long len = (long)st->rlen[i];
        if (len < RTP_HDR || (d[0] >> 6) != 2)
            continue; /* not RTP v2: drop, like the Python parse */
        uint8_t pt = d[1] & 0x7F;
        uint32_t ts = be32(d + 4);
        uint32_t ssrc = be32(d + 8);
        uint16_t seq = (uint16_t)((d[2] << 8) | d[3]);

        /* RFC 3550 reception stats for every valid RTP packet — the ONE
         * accounting point in fast mode (slow-path packets must not be
         * re-counted by the caller) */
        vrx_ssrc *sc = get_ssrc(st, ssrc);
        if (i != resumed) {
            if (sc)
                ssrc_update(sc, seq, ts, now);
            st->pkts_total++;
            st->bytes_total += (uint64_t)len;
        }

        int hdr_ok = (d[0] & 0x1F) == 0; /* no CSRCs, no extension */
        int ph_len = pt == PT_VIDEO ? VIDEO_PH
                   : (pt == PT_VIDEO_LDGM || pt == PT_VIDEO_RS) ? FEC_PH : 0;
        if (!hdr_ok || ph_len == 0 || len < RTP_HDR + ph_len)
            goto overflow;

        {
            const unsigned char *ph = d + RTP_HDR;
            uint32_t w0 = be32(ph);
            uint32_t sub = w0 >> 22;
            uint64_t off = be32(ph + 4);
            uint64_t flen = be32(ph + 8);
            if (flen == 0 || flen > st->max_frame_len)
                continue; /* bogus header: drop (Python path logs same) */

            vrx_slot *s = find_slot(st, ssrc, ts, sub, pt);
            if (!s) {
                /* newer-frame completion (pbuf.c:466): a packet of a NEW
                 * frame completes every slot of the previous TS */
                if (sc && sc->have_ts && ts != sc->last_ts) {
                    if (((ts - sc->last_ts) & 0xFFFFFFFFu) < 0x80000000u) {
                        for (int k = 0; k < st->nslots; k++) {
                            vrx_slot *o = &st->slots[k];
                            if (o->in_use && o->ssrc == ssrc &&
                                o->ts == sc->last_ts)
                                o->completed = 1;
                        }
                    }
                }
                if (sc) {
                    sc->last_ts = ts;
                    sc->have_ts = 1;
                }
                int fi = -1;
                for (int k = 0; k < st->nslots; k++)
                    if (!st->slots[k].in_use && st->slots[k].buf) {
                        fi = k;
                        break;
                    }
                if (fi < 0) {
                    *flags |= VRX_F_SLOTS_FULL;
                    goto overflow;
                }
                s = &st->slots[fi];
                if (flen > s->cap) {
                    if (i == resumed)
                        goto overflow; /* the caller could not grow it */
                    /* hold the batch here until the caller has grown
                     * its free slots to flen */
                    *flags |= VRX_F_NEED_CAP;
                    *need_cap = (long)flen;
                    st->held_i = i;
                    st->held_n = n;
                    return n;
                }
                uint8_t *buf = s->buf;
                uint64_t cap = s->cap;
                uint32_t gen = s->gen + 1;
                memset(s, 0, sizeof(*s));
                s->buf = buf;
                s->cap = cap;
                s->gen = gen;
                s->in_use = 1;
                s->ssrc = ssrc;
                s->ts = ts;
                s->substream = sub;
                s->pt = pt;
                s->frame_len = flen;
                s->arrival = now;
                memcpy(s->hdr, ph, (size_t)ph_len);
            }
            s->pkts++;
            if (d[1] & 0x80) {
                /* marker: completes every substream slot of this frame */
                for (int k = 0; k < st->nslots; k++) {
                    vrx_slot *o = &st->slots[k];
                    if (o->in_use && o->ssrc == ssrc && o->ts == ts)
                        o->mbit = 1;
                }
            }
            uint64_t dlen = (uint64_t)(len - RTP_HDR - ph_len);
            if (dlen == 0 || off >= s->frame_len)
                continue;
            uint64_t end = off + dlen;
            if (end > s->frame_len)
                end = s->frame_len;
            memcpy(s->buf + off, d + RTP_HDR + ph_len, (size_t)(end - off));
            s->bytes += end - off;
            iv_insert(s, off, end);
            continue;
        }

    overflow:
        if (*n_ovf < max_ovf && len <= ovf_slot_size) {
            memcpy(ovf_buf + (long)(*n_ovf) * ovf_slot_size, d, (size_t)len);
            ovf_lens[*n_ovf] = (int)len;
            (*n_ovf)++;
        }
    }
    return n - i0;
}

#define VRX_META_WORDS 12

/* Bulk slot state export: out must hold nslots * VRX_META_WORDS u64s.
 * Layout per slot: [in_use, gen, ssrc, ts, substream, pt,
 *                   mbit | completed<<1, frame_len, pkts,
 *                   arrival (double bits), n_iv | iv_overflow<<32, bytes] */
void vrx_poll(void *p, uint64_t *out)
{
    vrx_state *st = p;
    for (int i = 0; i < st->nslots; i++) {
        vrx_slot *s = &st->slots[i];
        uint64_t *o = out + (long)i * VRX_META_WORDS;
        o[0] = (uint64_t)s->in_use;
        o[1] = s->gen;
        o[2] = s->ssrc;
        o[3] = s->ts;
        o[4] = s->substream;
        o[5] = s->pt;
        o[6] = (uint64_t)s->mbit | ((uint64_t)s->completed << 1);
        o[7] = s->frame_len;
        o[8] = s->pkts;
        memcpy(&o[9], &s->arrival, 8);
        o[10] = (uint64_t)(uint32_t)s->n_iv |
                ((uint64_t)(uint32_t)s->iv_overflow << 32);
        o[11] = s->bytes;
    }
}

int vrx_nslots(void *p) { return ((vrx_state *)p)->nslots; }

void vrx_slot_hdr(void *p, int slot, unsigned char *out)
{
    vrx_state *st = p;
    if (slot < 0 || slot >= st->nslots)
        return;
    memcpy(out, st->slots[slot].hdr, VIDEO_PH);
}

/* Copies interval pairs; returns n_iv. */
long vrx_slot_intervals(void *p, int slot, uint64_t *out)
{
    vrx_state *st = p;
    if (slot < 0 || slot >= st->nslots)
        return 0;
    vrx_slot *s = &st->slots[slot];
    memcpy(out, s->iv, (size_t)s->n_iv * sizeof(s->iv[0]));
    return s->n_iv;
}

/* Per-SSRC RFC 3550 stats export: out[8] = [ssrc, received, base_seq,
 * extended_max (cycles + max_seq), jitter (double bits), 0, 0, 0].
 * Returns 1 if the index is a live source, else 0. */
long vrx_ssrc_stats(void *p, int idx, uint64_t *out)
{
    vrx_state *st = p;
    if (idx < 0 || idx >= VRX_MAX_SSRC || !st->ssrcs[idx].in_use)
        return 0;
    vrx_ssrc *sc = &st->ssrcs[idx];
    out[0] = sc->ssrc;
    out[1] = sc->received;
    out[2] = sc->base_seq;
    out[3] = (uint64_t)sc->cycles + sc->max_seq;
    memcpy(&out[4], &sc->jitter, 8);
    out[5] = out[6] = out[7] = 0;
    return 1;
}

void vrx_totals(void *p, uint64_t *pkts, uint64_t *bytes)
{
    vrx_state *st = p;
    *pkts = st->pkts_total;
    *bytes = st->bytes_total;
}
