// The JPEG entropy assembly on the card: K1's per-block slots and bit
// counts in, the byte-stuffed entropy-coded scan with its RST markers out,
// byte-equal to native/jpeg_assemble.c::jpeg_assemble_3c.
//
// Replaces no Pallas kernel: the JAX package assembles the scan on the host
// (native/jpeg_assemble.c under ultragrid_tpu/ops/jpeg.py).  This kernel
// takes that host stage's place on the sender, so the slots (16.6 MB an 8K
// band at 16 words a block) never leave the card: only the file does.
//
// Restart segments are byte-aligned and independent, so a warp takes one
// segment.  Three kernels on the caller's stream:
//   1. jpeg_assemble_pack_kernel, one warp a segment: in chunks of 32
//      blocks (one a lane; a block is ky luma blocks then Cb then Cr of an
//      MCU, as the C code walks them), a warp prefix sum of the bit counts
//      places each block's bits in the segment's bit stream, and each lane
//      ORs its block's words, shifted to their place, into a ring of words
//      in shared memory.  The complete words go out byte-swapped (the stream
//      is MSB first) to the segment's stretch of a scratch buffer, and the
//      0xFF bytes among them are counted.  The last byte is filled with
//      1-bits.  Per segment: its bytes before stuffing, and its length
//      after: those bytes, one 0x00 after each 0xFF, and the 2-byte RST
//      marker before it (every segment but the frame's first).
//   2. jpeg_assemble_scan_kernel, one block: the exclusive sum of the
//      segments' lengths (their offsets), the body's length, and K1's
//      overflow flag beside it, so the host learns both in one read.
//   3. jpeg_assemble_write_kernel, one warp a segment: the marker, then the
//      segment's bytes, 4 a lane, each 0xFF followed by 0x00, placed by a
//      warp prefix sum of the bytes each lane emits; the last segment's
//      warp writes the EOI (0xFF 0xD9) where asked.
// `first_seg` numbers the markers in the frame: the marker before segment s
// is RST((first_seg + s - 1) mod 8), and the first segment has one unless
// first_seg is 0.  So a row band of a frame (ops/jpeg.py, the banded
// sender) writes its markers as they stand in the frame, and the bands'
// bodies are joined as they are.  Bits of a block past its slot (a count
// above 32 * wwords: K1's overflow, which the caller widens the slots for
// and encodes again) are not read.
//
// What bounds it on an H100: memory, and little of it.  Each block's used
// slot words and its bit count are read once, the scratch is written and
// read once, and the file written once: at 8K a band's 1.0 MB of bit counts
// and about 1.5 MB of coded bytes, a few microseconds at 3.35 TB/s.  The
// plain PyTorch version is ops/jpeg_assemble_cuda.py::assemble_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // segments (warps) a block

// number of bytes equal to 0xFF among the `n` (0-4) first bytes, in stream
// order, of the big-endian word x
__device__ __forceinline__ int ff_bytes(uint32_t x, int n)
{
    uint32_t eq = __vcmpeq4(x, FULL);  // 0xFF in each byte that is 0xFF
    if (n < 4) eq &= n > 0 ? ~(FULL >> (8 * n)) : 0u;
    return __popc(eq) >> 3;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane)
{
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += o;
    }
    return v;
}

__device__ __forceinline__ long long warp_inclusive_scan64(long long v, int lane)
{
    for (int d = 1; d < 32; d <<= 1) {
        const long long o = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += o;
    }
    return v;
}

__device__ __forceinline__ int warp_sum(int v)
{
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    return v;
}

// the slot and bit count of block j (in stream order) of MCU run m0..
struct Slots {
    const uint32_t* ys;
    const int32_t* yb;
    const uint32_t* us;
    const int32_t* ub;
    const uint32_t* vs;
    const int32_t* vb;
};

__global__ void jpeg_assemble_pack_kernel(Slots sl, long long nmcu, int ky, int ww, int ri, int nseg,
                                          long long seg_words, int first_seg, uint32_t* scratch,
                                          int32_t* seg_bytes, int64_t* seg_len)
{
    extern __shared__ uint32_t smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int s = blockIdx.x * WARPS + warp;
    if (s >= nseg) return;  // whole warps leave together
    const int ring = 32 * ww + 2;
    uint32_t* sh = smem + warp * ring;
    for (int i = lane; i < ring; i += 32) sh[i] = 0;
    __syncwarp();

    const int bpm = ky + 2;
    const long long m0 = (long long)s * ri;
    const long long m1 = m0 + ri < nmcu ? m0 + ri : nmcu;
    const long long nb = (m1 - m0) * bpm;
    const int cap = 32 * ww;
    uint32_t* out = scratch + (long long)s * seg_words;
    long long pos = 0;    // bits placed so far
    long long wbase = 0;  // the stream word that sh[0] holds
    int ff = 0;
    for (long long c0 = 0; c0 < nb; c0 += 32) {
        const long long j = c0 + lane;
        int n = 0;
        const uint32_t* slot = nullptr;
        if (j < nb) {
            const long long m = m0 + j / bpm;
            const int c = (int)(j % bpm);
            int bits;
            if (c < ky) {
                slot = sl.ys + (m * ky + c) * ww;
                bits = sl.yb[m * ky + c];
            } else if (c == ky) {
                slot = sl.us + m * ww;
                bits = sl.ub[m];
            } else {
                slot = sl.vs + m * ww;
                bits = sl.vb[m];
            }
            n = bits < 0 ? 0 : (bits > cap ? cap : bits);
        }
        const int incl = warp_inclusive_scan(n, lane);
        const int chunk = __shfl_sync(FULL, incl, 31);
        // this block's first bit, counted from the first bit of sh[0]
        const long long rel = pos - 32 * wbase + (incl - n);
        for (int w = 0; 32 * w < n; ++w) {
            uint32_t v = slot[w];
            const int keep = n - 32 * w;
            if (keep < 32) v &= ~(FULL >> keep);
            const long long p = rel + 32 * w;
            const int q = (int)(p >> 5);
            const int sh_ = (int)(p & 31);
            atomicOr(&sh[q], v >> sh_);
            if (sh_) atomicOr(&sh[q + 1], v << (32 - sh_));
        }
        __syncwarp();
        const long long npos = pos + chunk;
        const int full = (int)((npos >> 5) - wbase);  // whole words in sh
        for (int i = lane; i < full; i += 32) {
            const uint32_t x = sh[i];
            ff += ff_bytes(x, 4);
            out[wbase + i] = __byte_perm(x, 0, 0x0123);
        }
        __syncwarp();
        const uint32_t carry = sh[full];
        const int used = (int)(((npos + 31) >> 5) - wbase) + 1;
        __syncwarp();  // every lane has read the carry before sh[full] is cleared
        for (int i = lane; i < used && i < ring; i += 32) sh[i] = 0;
        __syncwarp();
        if (lane == 0) sh[0] = carry;
        __syncwarp();
        pos = npos;
        wbase = npos >> 5;
    }
    ff = warp_sum(ff);
    if (lane == 0) {
        // the last word: the partial byte filled with 1-bits
        const int r = (int)(pos - 32 * wbase);  // bits in sh[0]
        const int pad = (8 - (r & 7)) & 7;
        uint32_t x = sh[0];
        if (pad) x |= ((1u << pad) - 1u) << (32 - r - pad);
        const int tail = (r + 7) >> 3;  // bytes in the last word
        if (tail) {
            ff += ff_bytes(x, tail);
            out[wbase] = __byte_perm(x, 0, 0x0123);
        }
        const long long nbytes = 4 * wbase + tail;
        seg_bytes[s] = (int32_t)nbytes;
        seg_len[s] = nbytes + ff + ((long long)first_seg + s > 0 ? 2 : 0);
    }
}

constexpr int SCAN_THREADS = 1024;

// offsets[s] = sum of seg_len[0..s-1]; info = [total, overflow]
__global__ void jpeg_assemble_scan_kernel(const int64_t* seg_len, int nseg, const uint8_t* ovf,
                                          int64_t* offsets, int64_t* info)
{
    __shared__ long long warp_tot[SCAN_THREADS / 32];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int per = (nseg + SCAN_THREADS - 1) / SCAN_THREADS;
    const int a = t * per;
    const int b = a + per < nseg ? a + per : nseg;
    long long own = 0;
    for (int i = a; i < b; ++i) own += seg_len[i];
    const long long incl = warp_inclusive_scan64(own, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const long long v = warp_inclusive_scan64(warp_tot[lane], lane);
        warp_tot[lane] = v;
    }
    __syncthreads();
    long long run = (warp ? warp_tot[warp - 1] : 0) + incl - own;
    for (int i = a; i < b; ++i) {
        offsets[i] = run;
        run += seg_len[i];
    }
    if (t == SCAN_THREADS - 1) {
        offsets[nseg] = run;  // the last thread's run ends at the total
        info[0] = run;
        info[1] = ovf ? (int64_t)(*ovf != 0) : 0;
    }
}

__global__ void jpeg_assemble_write_kernel(const uint32_t* scratch, long long seg_words, const int32_t* seg_bytes,
                                           const int64_t* offsets, int nseg, int first_seg, int eoi,
                                           uint8_t* body)
{
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (s >= nseg) return;
    long long off = offsets[s];
    if ((long long)first_seg + s > 0) {
        if (lane == 0) {
            body[off] = 0xFF;
            body[off + 1] = (uint8_t)(0xD0 + ((first_seg + s - 1) & 7));
        }
        off += 2;
    }
    const uint32_t* src = scratch + (long long)s * seg_words;
    const int n = seg_bytes[s];
    for (int base = 0; base < n; base += 128) {
        const int i = base + 4 * lane;
        const int valid = n - i < 0 ? 0 : (n - i > 4 ? 4 : n - i);
        const uint32_t x = valid ? src[i >> 2] : 0u;  // bytes in stream order, the first lowest
        int emit = valid;
        for (int k = 0; k < valid; ++k) emit += ((x >> (8 * k)) & 0xFFu) == 0xFFu;
        const int incl = warp_inclusive_scan(emit, lane);
        long long p = off + incl - emit;
        for (int k = 0; k < valid; ++k) {
            const uint8_t c = (uint8_t)(x >> (8 * k));
            body[p++] = c;
            if (c == 0xFF) body[p++] = 0x00;
        }
        off += __shfl_sync(FULL, incl, 31);
    }
    if (eoi && s == nseg - 1 && lane == 0) {
        const long long end = offsets[nseg];
        body[end] = 0xFF;
        body[end + 1] = 0xD9;
    }
}

}  // namespace

// The count pass and the scan: ys/us/vs uint32 [blocks, ww] slots, yb/ub/vb
// int32 bit counts (luma nmcu * ky, chroma nmcu each); scratch uint32
// [nseg, ri * (ky + 2) * ww]; seg_bytes int32 [nseg]; seg_len int64 [nseg];
// offsets int64 [nseg + 1]; info int64 [2] = (body length, K1's overflow
// flag, read from `ovf`, a byte, where given).
extern "C" int ug_jpeg_assemble_count(const void* ys, const void* yb, const void* us, const void* ub,
                                      const void* vs, const void* vb, const void* ovf, long long nmcu,
                                      int ky, int ww, int ri, int first_seg, void* scratch,
                                      void* seg_bytes, void* seg_len, void* offsets, void* info,
                                      void* stream)
{
    if (nmcu <= 0 || ky < 1 || ky > 4 || ww < 1 || ww > 64 || ri < 1 || first_seg < 0)
        return (int)cudaErrorInvalidValue;
    const long long nseg_l = (nmcu + ri - 1) / ri;
    if (nseg_l > (1LL << 30)) return (int)cudaErrorInvalidValue;
    const int nseg = (int)nseg_l;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // a ring of 32 * ww + 2 words a warp: 32.8 KB a block at ww = 64, under the 48 KB default
    const size_t smem = (size_t)WARPS * (32 * ww + 2) * sizeof(uint32_t);
    Slots sl{static_cast<const uint32_t*>(ys), static_cast<const int32_t*>(yb),
             static_cast<const uint32_t*>(us), static_cast<const int32_t*>(ub),
             static_cast<const uint32_t*>(vs), static_cast<const int32_t*>(vb)};
    const long long seg_words = (long long)ri * (ky + 2) * ww;
    jpeg_assemble_pack_kernel<<<(nseg + WARPS - 1) / WARPS, 32 * WARPS, smem, st>>>(
        sl, nmcu, ky, ww, ri, nseg, seg_words, first_seg, static_cast<uint32_t*>(scratch),
        static_cast<int32_t*>(seg_bytes), static_cast<int64_t*>(seg_len));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    jpeg_assemble_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
        static_cast<const int64_t*>(seg_len), nseg, static_cast<const uint8_t*>(ovf),
        static_cast<int64_t*>(offsets), static_cast<int64_t*>(info));
    return (int)cudaGetLastError();
}

// The write pass of what ug_jpeg_assemble_count left: the body (and the
// EOI where `eoi`) into `body`, which holds offsets[nseg] (+ 2) bytes.
extern "C" int ug_jpeg_assemble_write(const void* scratch, const void* seg_bytes, const void* offsets,
                                      long long nmcu, int ky, int ww, int ri, int first_seg, int eoi,
                                      void* body, void* stream)
{
    if (nmcu <= 0 || ky < 1 || ky > 4 || ww < 1 || ww > 64 || ri < 1 || first_seg < 0)
        return (int)cudaErrorInvalidValue;
    const int nseg = (int)((nmcu + ri - 1) / ri);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    jpeg_assemble_write_kernel<<<(nseg + WARPS - 1) / WARPS, 32 * WARPS, 0, st>>>(
        static_cast<const uint32_t*>(scratch), (long long)ri * (ky + 2) * ww,
        static_cast<const int32_t*>(seg_bytes), static_cast<const int64_t*>(offsets), nseg, first_seg, eoi,
        static_cast<uint8_t*>(body));
    return (int)cudaGetLastError();
}
