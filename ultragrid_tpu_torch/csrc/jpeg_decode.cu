// The JPEG entropy decode on the card: a receiver's file in, the reverse
// product's float32 input out, for baseline 4:2:2 three-component scans
// with restart markers (ops/jpeg.py::JpegDecoder.decode_to_uyvy).
//
// Replaces no Pallas kernel: the JAX package decodes the entropy-coded scan
// on the host (native/jpeg_scan_decode.c under
// ultragrid_tpu/ops/jpeg.py::entropy_decode_422_packed) and uploads the
// coefficients.  This kernel takes that host stage's place for the streams
// it can take; the C decoder stays for every other stream.
//
// Two C entries: ug_jpeg_upload (the file into the pinned staging buffer
// and one asynchronous copy up) and ug_jpeg_decode, three kernels:
//   1. jpeg_rst_count_kernel, one warp per 512-byte tile of the scan: its
//      RST markers (0xFF then 0xD0-0xD7; stuffed data has 0x00 after every
//      0xFF, so no marker hides inside a segment), counted, with their
//      total in the status word.
//   2. jpeg_rst_place_kernel, the same tiles: each warp adds the counts of
//      the tiles before its own and writes its markers' segment offsets in
//      file order.  Nothing on the host walks the entropy-coded bytes.
//   3. jpeg_segment_decode_kernel, one warp per restart segment of the
//      range asked for (the whole scan, or one row band's segments when a
//      frame is decoded by band over several cards):
//      - the 32 lanes unstuff the segment into a 2 KB ring in shared
//        memory, 512 bytes at a time: one 16-byte load per lane, a ballot
//        for the segment's end (0xFF not followed by 0x00, or the file's
//        end), a warp prefix sum of the kept bytes to compact them;
//      - lane 0 walks the symbol chain (each symbol starts where the one
//        before ends) over an 11-bit first-level Huffman table in shared
//        memory (Y's and the chroma components' shared tables), whose
//        entry gives the bits a symbol takes, the step to its coefficient
//        and, for a code and extension of at most 11 bits, its value, with
//        the canonical walk of native/jpeg_scan_decode.c behind it; the DC
//        predictors start at 0 in each segment;
//      - per MCU, the 32 lanes convert its 256 coefficients to float32,
//        store them with two coalesced 16-byte stores each and zero the
//        staging row.
//      Output q [nmcu, 256]: lanes [Y left | Y right | Cb | Cr] x 64 in
//      zigzag order, the layout of ops/jpeg.py::packed_coefficients;
//      integers are exact in float32.
// The decode follows the C decoder's rules, so a segment stops here where
// it stops there, and q equals its coefficients wherever both decode a
// segment to its end: a code of at most 16 bits that no table holds, a run
// past coefficient 63, or a read past the segment's end (checked once an
// MCU) stops it, except where only the extension of the segment's last
// symbol is missing, which the C decoder takes as 0 and so does this one.
// (Tables the entries cannot carry, a DC size above 16 or a code and
// extension of more than 31 bits, never reach the card:
// ops/jpeg_decode_cuda.py::huffman_tables refuses them.)  The status word
// counts the segments that stopped early and the MCUs decoded; the host
// reads it once a frame and raises where either is off, as the C decoder
// does for the same stream.  The plain PyTorch version is
// ops/jpeg_decode_cuda.py::segment_decode_plain.
//
// What bounds it on an H100: at 1080p q80 it reads 0.39 MB of file and
// writes 16.6 MB of float32 (16,200 MCUs x 1 KB), 5.1 us at 3.35 TB/s.
// The real limit is the serial symbol chain: a 1080p segment (30 MCUs,
// about 720 bytes) is about 1,500 symbols one after the other.  One warp a
// segment puts all 540 segments of a frame in flight at once (about four
// warps on each SM), so the kernel takes about as long as its longest
// chain; the unstuffing and the stores, which all lanes share, stay off
// the chain, and the chain reads its tables and bytes from shared memory.
// With one warp on each scheduler, the warp issues in order and each of a
// symbol's instructions waits on the one before: clock64 stamps on an H100
// read about 190 cycles a symbol.  So the chain has no branch but a long
// code's and the loop's: the entry carries the value of a short code, the
// refill is branch-free, failures are read once a block, and the
// coefficients are stored as integers, which all lanes convert.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstring>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;             // segments (warps) per block of the decode
constexpr int RING = 2048;           // unstuffed bytes a warp holds in shared memory
constexpr int AHEAD = 1280;          // unstuff more while fewer bytes are ahead of the reader
constexpr int CHUNK = 16 * 32;       // stuffed bytes a warp reads per step: 16 a lane
constexpr int TILE = CHUNK;          // bytes of the scan a warp of the marker kernels reads
constexpr int TILE_WARPS = 8;        // tiles per block of the marker kernels
constexpr int LUT_BITS = 11;

// One Huffman table, as ops/jpeg_decode_cuda.py::huffman_tables lays it out.
// An entry holds what the decode does with a symbol: the bits of its code
// and its extension together (bits 0-4), the step to the next coefficient
// (5-11: run + 1, 16 for ZRL, 64 for EOB and any other AC symbol of size 0,
// 0 in a DC table), HAS_EXT (13: the symbol has extension bits), FAIL_BIT
// (14: the decode stops here: a DC size above 16, more than 31 bits, or no
// code), and the extension's value as int16 (16-31).  Where the code and
// its extension do not fit in the 11 bits of lut, LONG (12) is set and
// bits 16-20 / 21-25 hold the code's length and the extension's size; the
// value is read from the bits.  lut holds an entry under every 11-bit
// prefix that starts with a code of <= 11 bits, 0 under the others.
constexpr uint32_t LONG = 1u << 12, HAS_EXT = 1u << 13, FAIL_BIT = 1u << 14;
constexpr uint32_t FAIL = FAIL_BIT | 64u << 5;

__device__ __forceinline__ uint32_t long_entry(uint32_t len, uint32_t sym, bool ac)
{
    const uint32_t size = ac ? sym & 15u : sym;
    if (size > 16 || len + size > 31) return FAIL;
    const uint32_t step = !ac ? 0u : size ? (sym >> 4) + 1u : sym == 0xF0 ? 16u : 64u;
    return (len + size) | step << 5 | LONG | (size ? HAS_EXT : 0u) | len << 16 | size << 21;
}

struct HuffTab {
    uint32_t lut[1 << LUT_BITS];
    int32_t maxcode[18];          // largest code of each length, -1 where none
    int32_t valoff[17];           // index in huffval of a code of length l: code + valoff[l]
    uint8_t huffval[256];
    uint8_t pad[4];

    // the canonical walk (native/jpeg_scan_decode.c) for codes of 12-16
    // bits, where lut has no code that the next bits start with
    __device__ __noinline__ uint32_t walk(uint32_t top, bool ac) const
    {
        for (int l = LUT_BITS + 1; l <= 16; ++l) {
            const int code = (int)(top >> (32 - l));
            if (code <= maxcode[l]) return long_entry(l, huffval[(code + valoff[l]) & 0xFF], ac);
        }
        return FAIL;
    }
};
static_assert(sizeof(HuffTab) == 8592, "layout shared with ops/jpeg_decode_cuda.py");

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int j)
{
    return (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane)
{
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += o;
    }
    return v;
}

// The RST markers whose 0xFF lies in this lane's 16 bytes of the tile at
// `base` (all 32 lanes): bit j for byte base + 16 * lane + j.
__device__ __forceinline__ uint32_t marker_mask(const uint8_t* __restrict__ file, long long len,
                                                long long start, long long base, int lane)
{
    const long long p0 = base + 16 * lane;
    const uint4 v = *reinterpret_cast<const uint4*>(file + p0);  // padded past len
    uint32_t next = __shfl_down_sync(FULL, v.x & 0xFFu, 1);
    if (lane == 31) next = file[base + TILE];
    const uint32_t ww[5] = {v.x, v.y, v.z, v.w, next};
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
        if (byte_of(ww, j) == 0xFF && (byte_of(ww, j + 1) & 0xF8) == 0xD0) m |= 1u << j;
    if (p0 < start || p0 + 17 > len) {  // the scan's first and last tiles
#pragma unroll
        for (int j = 0; j < 16; ++j)
            if (p0 + j < start || p0 + j + 1 >= len) m &= ~(1u << j);
    }
    return m;
}

// counts[t] = the markers of tile t (bytes [base + TILE t, base + TILE (t + 1)),
// base = start & ~15); status[2] += each count (zero before the launch).
__global__ void __launch_bounds__(TILE_WARPS * 32) jpeg_rst_count_kernel(
    const uint8_t* __restrict__ file, long long len, long long start, int ntiles,
    int* __restrict__ counts, int* __restrict__ status)
{
    const int lane = threadIdx.x & 31;
    const int tile = blockIdx.x * TILE_WARPS + (threadIdx.x >> 5);
    if (tile >= ntiles) return;
    const int c = __reduce_add_sync(FULL, __popc(marker_mask(file, len, start, (start & ~15LL) +
                                                              (long long)tile * TILE, lane)));
    if (lane == 0) {
        counts[tile] = c;
        if (c) atomicAdd(&status[2], c);
    }
}

// off[0] = start; off[1 + i] = the byte after marker i, for i < nseg - 1.
__global__ void __launch_bounds__(TILE_WARPS * 32) jpeg_rst_place_kernel(
    const uint8_t* __restrict__ file, long long len, long long start, int ntiles,
    const int* __restrict__ counts, int nseg, long long* __restrict__ off)
{
    __shared__ int before_warp[TILE_WARPS];
    __shared__ int tile_count[TILE_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int first = blockIdx.x * TILE_WARPS, tile = first + warp;
    int acc = 0;
    for (int i = threadIdx.x; i < first; i += TILE_WARPS * 32) acc += counts[i];
    before_warp[warp] = __reduce_add_sync(FULL, acc);
    tile_count[warp] = tile < ntiles ? counts[tile] : 0;
    __syncthreads();
    int idx = 0;
    for (int i = 0; i < TILE_WARPS; ++i) idx += before_warp[i] + (i < warp ? tile_count[i] : 0);
    if (blockIdx.x == 0 && threadIdx.x == 0) off[0] = start;
    if (tile >= ntiles || tile_count[warp] == 0) return;
    const long long base = (start & ~15LL) + (long long)tile * TILE;
    uint32_t m = marker_mask(file, len, start, base, lane);
    const int c = __popc(m);
    idx += warp_inclusive_sum(c, lane) - c;
    while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        if (idx < nseg - 1) off[1 + idx] = base + 16 * lane + j + 2;
        ++idx;
    }
}

// Lane 0's bit reader over its warp's ring of unstuffed bytes, read as
// big-endian 32-bit words.
struct Reader {
    const uint32_t* ring;
    uint32_t hi, lo; // the next `cnt` bits of the segment, left-aligned in hi:lo
    int cnt;
    int rword;       // the ring word held in nextw; words before it are in hi:lo or consumed
    uint32_t nextw;
    uint32_t last;   // the entry of the last block's last symbol

    __device__ __forceinline__ uint32_t word(int i) const
    {
        return __byte_perm(ring[i & (RING / 4 - 1)], 0, 0x0123);
    }

    // >= 32 bits in hi:lo (a code and its extension take at most 31),
    // without a branch: the warp issues in order, so a skipped branch
    // costs the chain as much as the refill
    __device__ __forceinline__ void fill()
    {
        const uint32_t after = word(rword + 1);
        const uint32_t need = (uint32_t)(cnt - 32) >> 31;  // 1 where cnt < 32
        hi |= (nextw >> (cnt & 31)) & (0u - need);
        lo = need ? __funnelshift_lc(0u, nextw, 32 - cnt) : lo;  // nextw << (32 - cnt), 0 for a shift of 32
        cnt += (int)(need << 5);
        rword += (int)need;
        nextw = need ? after : nextw;
    }

    __device__ __forceinline__ int consumed_bits() const { return rword * 32 - cnt; }

    // The next symbol's entry (HuffTab), its bits still in hi:lo.
    __device__ __forceinline__ uint32_t entry(const HuffTab& T, bool ac)
    {
        fill();
        uint32_t e = T.lut[hi >> (32 - LUT_BITS)];
        if (__builtin_expect(e == 0, 0)) e = T.walk(hi, ac);
        return e;
    }

    // The symbol of entry e, whose code starts hi:lo, taken: its extension
    // as a signed value (F.2.2.1 EXTEND), 0 where it has none.
    __device__ __forceinline__ int take(uint32_t e)
    {
        int v = (int)e >> 16;
        if (__builtin_expect(e & LONG, 0)) {
            const uint32_t size = e >> 21 & 31;
            const int u = (int)__funnelshift_rc(hi << (e >> 16 & 31), 0u, 32 - size);  // 0 for size 0
            const int half = (1 << size) >> 1;
            v = u < half ? u - (2 * half - 1) : u;
        }
        hi = __funnelshift_l(lo, hi, e);  // the bits taken are e & 31
        lo = __funnelshift_l(0u, lo, e);
        cnt -= (int)(e & 31);
        return v;
    }

    // One 8x8 block into coef[0..63] (zero on entry); false where the
    // decode stops (FAIL, or a run past coefficient 63).  The AC loop
    // branches only for a long code and to loop: an EOB or a ZRL writes 0
    // at a place no coefficient of the block holds yet, and both failures
    // end the loop (FAIL steps 64), so they are read once, after it.
    __device__ __forceinline__ bool block(const HuffTab& dc, const HuffTab& ac, int& pred, int* coef)
    {
        uint32_t e = entry(dc, false);
        const uint32_t bad = e & FAIL_BIT;
        pred += take(e);
        coef[0] = (short)pred;
        int k = 1;
        do {
            e = entry(ac, true);
            const int step = (int)(e >> 5) & 127;
            coef[min(k + step - 1, 63)] = take(e);
            k += step;
        } while (k < 64);
        last = e;
        return !(bad | e & FAIL_BIT | (k > 64 && (e & HAS_EXT)));
    }

    // After a block decoded whole that read past the segment's `end` bit:
    // true where only its last symbol's extension lies past it (the symbol
    // then took coefficient 63, `v`), which the C decoder takes as 0.
    __device__ __forceinline__ bool only_last_extension_missing(int end, int v) const
    {
        if (!(last & HAS_EXT)) return false;
        const int size = (last & LONG) ? (int)(last >> 21 & 31) : 32 - __clz(abs(v));
        return consumed_bits() - size <= end;
    }
};

// Unstuff the next CHUNK stuffed bytes of a segment into the ring (all 32
// lanes; every argument but lane is the same in each).  A 0x00 after 0xFF
// is dropped; the segment ends at the first 0xFF not followed by 0x00, or
// at the file's end.
__device__ __forceinline__ void unstuff(const uint8_t* __restrict__ file, long long len, long long start,
                                        uint8_t* ring, long long& src, int& wpos, bool& at_end,
                                        uint32_t& prev, int lane)
{
    const long long a0 = src & ~15LL;
    const long long p0 = a0 + 16 * lane;
    const uint4 v = *reinterpret_cast<const uint4*>(file + p0);  // padded past len
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t next = __shfl_down_sync(FULL, v.x & 0xFFu, 1);
    if (lane == 31) next = file[a0 + CHUNK];
    uint32_t before = __shfl_up_sync(FULL, v.w >> 24, 1);
    if (lane == 0) before = prev;
    uint32_t keep = 0, end = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const long long p = p0 + j;
        const uint32_t b = byte_of(w, j);
        const uint32_t nb = j < 15 ? byte_of(w, j + 1) : next;
        const uint32_t pb = j > 0 ? byte_of(w, j - 1) : before;
        if (p < src) continue;
        if (p >= len || (b == 0xFF && (p + 1 >= len || nb != 0))) end |= 1u << j;
        else if (!(b == 0 && pb == 0xFF && p != start)) keep |= 1u << j;
    }
    const unsigned ends = __ballot_sync(FULL, end != 0);
    if (ends) {
        const int fl = __ffs(ends) - 1;
        const int fj = __shfl_sync(FULL, __ffs(end) - 1, fl);
        if (lane > fl) keep = 0;
        else if (lane == fl) keep &= (1u << fj) - 1u;
        at_end = true;
    }
    const int cnt = __popc(keep);
    const int inc = warp_inclusive_sum(cnt, lane);
    int wp = wpos + inc - cnt;
#pragma unroll
    for (int j = 0; j < 16; ++j)
        if (keep >> j & 1u) ring[(wp++) & (RING - 1)] = (uint8_t)byte_of(w, j);
    wpos += __shfl_sync(FULL, inc, 31);
    prev = __shfl_sync(FULL, v.w >> 24, 31);
    src = a0 + CHUNK;
}

__global__ void __launch_bounds__(WARPS * 32) jpeg_segment_decode_kernel(
    const uint8_t* __restrict__ file, long long len, const HuffTab* __restrict__ tabs_g,
    int td_y, int td_c, const long long* __restrict__ off, int nmcu, int ri, int nseg,
    int seg0, int seg1, float* __restrict__ q, int* __restrict__ status)
{
    __shared__ HuffTab tabs[4];  // Y DC, Y AC, chroma DC, chroma AC
    __shared__ __align__(16) uint8_t rings[WARPS][RING];
    __shared__ __align__(16) int rows[WARPS][256];  // an MCU's coefficients
    {
        constexpr int WORDS = sizeof(HuffTab) / 16;
        const uint4* src = reinterpret_cast<const uint4*>(tabs_g);
        uint4* dst = reinterpret_cast<uint4*>(tabs);
        for (int i = threadIdx.x; i < 4 * WORDS; i += blockDim.x) {
            const int t = i / WORDS;
            dst[i] = src[(2 * (t < 2 ? td_y : td_c) + (t & 1)) * WORDS + i % WORDS];
        }
        int4* r = reinterpret_cast<int4*>(rows);
        for (int i = threadIdx.x; i < WARPS * 64; i += blockDim.x) r[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int seg = seg0 + blockIdx.x * WARPS + warp;
    if (seg >= seg1 || status[2] != nseg - 1) return;  // a wrong marker count: the host falls back

    uint8_t* ring = rings[warp];
    int* row = rows[warp];
    const long long start = off[seg];
    const int m0 = seg * ri, m1 = min(m0 + ri, nmcu);
    long long src = start;
    int wpos = 0;
    bool at_end = false;
    uint32_t prev = 0;
    Reader rd{reinterpret_cast<const uint32_t*>(ring), 0, 0, 0, 0, 0, 0};
    int py = 0, pu = 0, pv = 0;
    int m = m0;
    bool ok = true;
    for (; m < m1; ++m) {
        // bytes taken by the reader: the words in buf and nextw
        const int taken = 4 * (__shfl_sync(FULL, rd.rword, 0) + 1);
        while (!at_end && wpos - taken < AHEAD) unstuff(file, len, start, ring, src, wpos, at_end, prev, lane);
        __syncwarp();
        if (lane == 0) {
            if (m == m0) rd.nextw = rd.word(0);
            ok = rd.block(tabs[0], tabs[1], py, row) && rd.block(tabs[0], tabs[1], py, row + 64) &&
                 rd.block(tabs[2], tabs[3], pu, row + 128) && rd.block(tabs[2], tabs[3], pv, row + 192);
            // a read past the segment's end stops it (checked once an MCU:
            // an MCU takes at most 1 KB, and AHEAD bytes are in the ring),
            // but for the last symbol's extension alone, read as 0
            if (at_end && rd.consumed_bits() > wpos * 8) {
                ok = ok && m == m1 - 1 && rd.only_last_extension_missing(wpos * 8, row[255]);
                row[255] = 0;
            }
        }
        ok = __shfl_sync(FULL, ok, 0);
        __syncwarp();
        if (!ok) break;
        float4* dst = reinterpret_cast<float4*>(q + (long long)(m - seg0 * ri) * 256);
        int4* r = reinterpret_cast<int4*>(row);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int4 c = r[lane + 32 * h];
            dst[lane + 32 * h] = make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
            r[lane + 32 * h] = make_int4(0, 0, 0, 0);
        }
        __syncwarp();
    }
    if (lane == 0) {
        if (!ok) atomicAdd(&status[0], 1);
        atomicAdd(&status[1], m - m0);
    }
}

}  // namespace

// file: uint8 [>= len + 1024] on the card, 16-byte aligned (the kernels'
// aligned loads run up to 1 KB past len); start: the first byte after SOS;
// tabs: 4 HuffTab (slot = table id * 2 + class), 16-byte aligned; td_y,
// td_c: the table ids of Y and of both chroma components (0 or 1, used for
// both classes as the C decoder does); counts: int32 [ntiles] scratch, ntiles = the tiles of TILE
// bytes from start & ~15 to len; off: int64 [nseg] scratch; segments seg0 to
// seg1 - 1 are decoded (0 and nseg for the whole scan; the markers are
// found over the whole scan either way); q: float32 [MCUs of those
// segments, 256], its row 0 MCU seg0 * ri, 16-byte aligned; status: int32
// [4], counting the stopped segments and the decoded MCUs of the range.
extern "C" int ug_jpeg_decode(const void* file, long long len, long long start, const void* tabs,
                              int td_y, int td_c, int nmcu, int ri, int nseg, void* counts,
                              int ntiles, void* off, void* q, void* status, int seg0, int seg1,
                              void* stream)
{
    if (len <= start || start < 2 || nmcu < 1 || ri < 1 || nseg != (nmcu - 1) / ri + 1 || td_y < 0 ||
        td_y > 1 || td_c < 0 || td_c > 1 || seg0 < 0 || seg1 <= seg0 || seg1 > nseg ||
        ntiles != (int)((len - (start & ~15LL) + TILE - 1) / TILE) ||
        reinterpret_cast<uintptr_t>(file) % 16 || reinterpret_cast<uintptr_t>(tabs) % 16 ||
        reinterpret_cast<uintptr_t>(q) % 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint8_t* f = static_cast<const uint8_t*>(file);
    int* c = static_cast<int*>(counts);
    long long* o = static_cast<long long*>(off);
    int* st = static_cast<int*>(status);
    cudaError_t err = cudaMemsetAsync(st, 0, 4 * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const int tile_blocks = (ntiles + TILE_WARPS - 1) / TILE_WARPS;
    jpeg_rst_count_kernel<<<tile_blocks, TILE_WARPS * 32, 0, s>>>(f, len, start, ntiles, c, st);
    jpeg_rst_place_kernel<<<tile_blocks, TILE_WARPS * 32, 0, s>>>(f, len, start, ntiles, c, nseg, o);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    jpeg_segment_decode_kernel<<<(seg1 - seg0 + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        f, len, static_cast<const HuffTab*>(tabs), td_y, td_c, o, nmcu, ri, nseg, seg0, seg1,
        static_cast<float*>(q), st);
    return (int)cudaGetLastError();
}

// The file into the pinned staging buffer, then one asynchronous copy of it
// to the device buffer: the host's copy and the upload in one call.
extern "C" int ug_jpeg_upload(void* pinned, const void* src, long long n, void* dev, void* stream)
{
    if (n <= 0) return (int)cudaErrorInvalidValue;
    memcpy(pinned, src, (size_t)n);
    return (int)cudaMemcpyAsync(dev, pinned, (size_t)n, cudaMemcpyHostToDevice,
                                static_cast<cudaStream_t>(stream));
}
