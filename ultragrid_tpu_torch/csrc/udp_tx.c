/* UDP transmit hot path: scatter-gather batch send with pacing.
 *
 * The port's copy of native/udp_tx.c.  Its pacer sleeps only while it is
 * ahead of the schedule: a batch that leaves after its slot goes on at
 * once, so the frame catches up, where the shared copy calls the sleep
 * anyway.  A host whose sleep costs tens of microseconds even for a past
 * deadline (a sandboxed kernel's timer) otherwise sends an 8K frame's
 * 4,700 datagrams at well under the rate the pacing asks for.
 *
 * The role of the reference's native send loop (ref: src/transmit.c:783-818
 * per-packet send + busy-wait shaping; src/rtp/net_udp.c:1259-1298 async
 * send + udp_sendv scatter-gather).  Python builds all packet headers as one
 * array (vectorized); this routine sends header_i + payload-slice_i pairs
 * with sendmmsg in batches, applying the inter-packet interval between
 * batches of `pace_batch` packets.
 *
 * Returns the number of packets sent, or -1 on socket error.
 */

#define _GNU_SOURCE
#include <errno.h>
#include <netinet/in.h>
#include <stdint.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <time.h>

#define MAX_BATCH 64

int64_t udp_send_packets(
    int sockfd,
    const uint8_t *headers, int32_t hdr_len,   /* [npkt][hdr_len] */
    const uint8_t *payload,                    /* shared payload buffer */
    const int64_t *offsets, const int32_t *sizes, int64_t npkt,
    int64_t pace_ns,                            /* inter-packet interval */
    const struct sockaddr *dest, socklen_t dest_len)
{
    struct mmsghdr msgs[MAX_BATCH];
    struct iovec iovs[MAX_BATCH][2];
    struct timespec next;
    clock_gettime(CLOCK_MONOTONIC, &next);

    int64_t sent = 0;
    while (sent < npkt) {
        int batch = npkt - sent > MAX_BATCH ? MAX_BATCH : (int)(npkt - sent);
        if (pace_ns > 0 && batch > 8) {
            batch = 8; /* finer pacing granularity when shaping */
        }
        for (int i = 0; i < batch; i++) {
            int64_t p = sent + i;
            iovs[i][0].iov_base = (void *)(headers + (size_t)p * hdr_len);
            iovs[i][0].iov_len = (size_t)hdr_len;
            iovs[i][1].iov_base = (void *)(payload + offsets[p]);
            iovs[i][1].iov_len = (size_t)sizes[p];
            memset(&msgs[i], 0, sizeof msgs[i]);
            msgs[i].msg_hdr.msg_iov = iovs[i];
            msgs[i].msg_hdr.msg_iovlen = 2;
            msgs[i].msg_hdr.msg_name = (void *)dest;
            msgs[i].msg_hdr.msg_namelen = dest_len;
        }
        int n = sendmmsg(sockfd, msgs, batch, 0);
        if (n < 0) {
            if (errno == EINTR || errno == EAGAIN) {
                continue;
            }
            return -1;
        }
        sent += n;
        if (pace_ns > 0 && sent < npkt) {
            next.tv_nsec += pace_ns * n;
            while (next.tv_nsec >= 1000000000L) {
                next.tv_nsec -= 1000000000L;
                next.tv_sec += 1;
            }
            struct timespec now;
            clock_gettime(CLOCK_MONOTONIC, &now);
            if (now.tv_sec < next.tv_sec || (now.tv_sec == next.tv_sec && now.tv_nsec < next.tv_nsec)) {
                clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next, NULL);
            }
        }
    }
    return sent;
}
