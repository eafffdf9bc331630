// K1: the whole device JPEG encode of one frame in one launch.
//
// Replaces ultragrid_tpu/ops/jpeg_pallas.py::make_fused_encode (the Pallas
// TPU kernel).  Computes, per MCU:
//   1. q = rint(bytes @ W - const): raw interleaved MCU bytes times the
//      "mega matrix" that folds deinterleave, colour conversion, the 2-D DCT,
//      zigzag and quantisation (ops/jpeg.py::JpegEncoder._build_mega_matrix);
//   2. DC differentials, reset at each restart segment's start (luma chains
//      Y0, Y1 [, Y10, Y11] inside and across MCUs; chroma per component);
//   3. AC run/size symbols with ZRL and EOB, Huffman codes from shared memory;
//   4. the MSB-first bit pack of every 8x8 block into `wwords` 32-bit words
//      plus its bit count.  Bits past wwords*32 are dropped while the count
//      keeps counting, so the caller sees the overflow and widens the slots.
// Output is bit-identical to the plain PyTorch path (ops/jpeg.py::
// JpegEncoder.encode_plain).
//
// What bounds it on an H100: FP32 FMAs.  W is mostly exact zeros: block group
// g (64 output columns) reads only the rows S_g of W with a non-zero entry,
// 64 of 256 bytes per group for 4:2:2 (16,384 FMA per MCU, 265 MFMA at
// 1080p, 7.9 us at 67 TFLOP/s), against 8.6 MB of traffic (2.6 us at
// 3.35 TB/s).  fmaf(x, 0, acc) == acc, so one fmaf chain over S_g in
// ascending k equals the dense chain bit for bit.
//
// Design:
// - Compact front end.  The host plan (ops/jpeg.py::support_plan) gives S_g
//   and Wc_g = W[S_g, 64g:64g+64], identical Wc_g stored once (4:2:2 and
//   4:2:0 have two distinct matrices).  Each CTA stages all Wc_g in dynamic
//   shared memory once.  Per tile of MT MCUs the raw bytes go to shared
//   memory, then are gathered per group into x[k][mcu] as f32.  A thread
//   owns 4 columns x 4 MCUs (16 accumulators): per k one 16-byte load of W
//   and one of x feed 16 fmaf.
// - Grid decoupled from the restart interval.  Persistent CTAs walk tiles of
//   MT MCUs.  A tile that starts inside a restart segment recomputes the DC
//   predictors of the MCU before it (last luma block, Cb, Cr) with the same
//   chain, so any interval fills the card.
// - Parallel pack.  Four lanes encode one block.  Shuffles gather the
//   block's non-zero mask; each lane codes an equal share of the non-zero
//   ACs by rank (lane 0 also the DC), deriving each one's run, ZRL count,
//   size and code (ZRLs folded into one piece of <= 60 bits).  A scan of bit
//   counts over the four lanes places each lane's bits (the last lane's
//   end with the EOB); a lane streams them MSB first, storing the words inside its range and ORing the two it
//   shares with its neighbours.  The slots of a tile are stored coalesced.
//   Measured on an H100 (chip_phases.py): a warp per block with a 32-lane
//   scan spent 59-63% of the tile in the pack, eight lanes of eight fixed
//   coefficients 50-61%, this design 40-43%.
// What holds it below its bound (chip_phases.py): the pack is still the
// largest phase, and staging and gather, which do no FMAs, take a fifth.
// Rounding is round-half-even (__float2int_rn), as torch.round/jnp.round.
//
// A second entry, ug_jpeg_plane_encode, runs the same pipeline in one launch
// for the geometries without a mega matrix, from the frame's planes (see
// jpeg_plane_encode_kernel).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int MT = 16;   // MCUs per tile
constexpr int RM = 4;    // MCUs per front-end thread
constexpr int CPT = 4;   // columns per front-end thread
constexpr int LPB = 4;   // pack: lanes per 8x8 block
constexpr int CPL = 64 / LPB;  // pack: coefficients per lane
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;  // cards whose launch set-up is kept

__device__ __forceinline__ int bit_length(int v)
{
    unsigned a = v < 0 ? 0u - (unsigned)v : (unsigned)v;
    return a ? 32 - __clz((int)a) : 0;
}

// amplitude bits of a coefficient of bit length s (one's complement for v<0)
__device__ __forceinline__ uint32_t amplitude(int v, int s)
{
    return (uint32_t)(v > 0 ? v : v - 1) & ((1u << s) - 1u);
}

// position of the set bit of rank r (from 0) in x; r < popcount(x)
__device__ __forceinline__ int nth_bit(unsigned long long x, int r)
{
    int pos = 0;
#pragma unroll
    for (int w = 32; w >= 1; w >>= 1) {
        const int c = __popcll(x & ((1ull << w) - 1ull));
        if (r >= c) {
            r -= c;
            x >>= w;
            pos += w;
        }
    }
    return pos;
}

// position of the first set bit of x above p, 64 if none
__device__ __forceinline__ int next_bit(unsigned long long x, int p)
{
    const unsigned long long rest = p >= 63 ? 0ull : x & ~((2ull << p) - 1ull);
    return rest ? __ffsll((long long)rest) - 1 : 64;
}

// Bytes of a raw MCU in shared memory: K plus one word, so the gather's 16
// MCUs of one row fall in different banks.
constexpr int RAW_PAD = 4;

// Symbols and pack of one tile of MT MCUs, then the tile's coalesced slot
// stores.  qs [MT][NC]: the tile's quantised coefficients (rows past nm may
// hold anything); carry: the DC of the MCU before the tile (last luma
// block, Cb, Cr), read only where the tile starts inside a restart segment;
// slots [MT * BPM][wwords] zeroed.  Called by all NC threads after a barrier.
template <int NC, int NY>
__device__ __forceinline__ void pack_tile(
    const int* qs, uint32_t* slots, const uint32_t* dc_tab, const uint32_t* ac_tab,
    const int* carry, uint32_t* __restrict__ ys, int32_t* __restrict__ ybits,
    uint32_t* __restrict__ us, int32_t* __restrict__ ubits,
    uint32_t* __restrict__ vs, int32_t* __restrict__ vbits,
    uint8_t* __restrict__ ovf, int m0, int nm, int ri, int wwords)
{
    constexpr int BPM = NY + 2;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    // ---- symbols + pack: LPB lanes per 8x8 block, CPL coefficients each ----
    constexpr int BPW = MT * BPM / (NC / 32);  // blocks per warp
    const int sub = lane / LPB, sl = lane - sub * LPB;
#pragma unroll 1
    for (int j = 0; j < BPW; j += 32 / LPB) {
        const int bl = warp * BPW + j + sub;
        const int i = bl / BPM, g = bl - i * BPM;  // i < MT: q exists past nm
        const int m = m0 + i;
        const int* q = qs + i * NC + g * 64;
        const bool luma = g < NY;
        const uint32_t* act = ac_tab + (luma ? 0 : 256);
        const uint32_t zrl = act[0xF0];
        const int zl = (int)(zrl & 31);

        // the block's non-zero AC positions, read a quarter per lane
        unsigned lm = 0;
#pragma unroll
        for (int c = 0; c < CPL; c += 4) {
            const int4 t = *reinterpret_cast<const int4*>(q + sl * CPL + c);
            lm |= (unsigned)(t.x != 0) << c | (unsigned)(t.y != 0) << (c + 1)
                  | (unsigned)(t.z != 0) << (c + 2) | (unsigned)(t.w != 0) << (c + 3);
        }
        unsigned long long nzm = (unsigned long long)lm << (sl * CPL);
#pragma unroll
        for (int d = 1; d < LPB; d <<= 1) nzm |= __shfl_xor_sync(FULL, nzm, d);
        nzm &= ~1ull;  // the DC is coded apart
        // this lane codes the non-zero ACs of ranks [r0, r1): an equal
        // share, in stream order
        const int nnz = __popcll(nzm);
        const int r0 = sl * nnz / LPB, r1 = (sl + 1) * nnz / LPB;
        const int p0 = r0 < r1 ? nth_bit(nzm, r0) : 64;
        const int prev0 = r0 > 0 ? nth_bit(nzm, r0 - 1) : 0;

        // the DC symbol (lane 0)
        uint32_t dc_piece = 0u;
        int dc_len = 0;
        if (sl == 0) {
            int pred;
            if (luma && g > 0) pred = q[-64];
            else if (m % ri == 0) pred = 0;
            else if (i > 0) pred = qs[(i - 1) * NC + (luma ? NY - 1 : g) * 64];
            else pred = carry[luma ? 0 : g - NY + 1];
            const int diff = q[0] - pred;
            const int s = bit_length(diff);
            const uint32_t e = dc_tab[(luma ? 0 : 16) + min(s, 15)];
            dc_piece = ((e >> 5) << s) | amplitude(diff, s);
            dc_len = (int)(e & 31) + s;
        }
        // AC symbol of the non-zero coefficient at jj, run zeros after
        // the one before: with its ZRL codes, one piece of len (<= 60) bits
        const uint64_t zrl2 = ((uint64_t)(zrl >> 5) << zl) | (zrl >> 5);
        const uint64_t zrl3 = (zrl2 << zl) | (zrl >> 5);
        auto symbol = [&](int jj, int run, uint64_t& piece, int& len) {
            const int vq = q[jj];
            const int sa = bit_length(vq);
            const uint32_t t = act[min(((run & 15) << 4) | sa, 255)];
            const int sym_len = max((int)(t & 31), 1) + sa;
            const int nz = run >> 4;
            const uint64_t zr = nz == 0 ? 0 : nz == 1 ? (uint64_t)(zrl >> 5) : nz == 2 ? zrl2 : zrl3;
            piece = (zr << sym_len) | ((uint64_t)(t >> 5) << sa) | amplitude(vq, sa);
            len = nz * zl + sym_len;
        };
        // the EOB ends the last lane's bits when the last coefficient is zero
        const int eob_len = sl == LPB - 1 && nzm >> 63 == 0 ? (int)(act[0] & 31) : 0;
        // pass 1: this lane's bit count
        int tot = dc_len + eob_len;
        for (int jj = p0, prev = prev0, r = r0; r < r1; ++r, prev = jj, jj = next_bit(nzm, jj)) {
            uint64_t piece;
            int len;
            symbol(jj, jj - prev - 1, piece, len);
            tot += len;
        }
        // place: inclusive scan of bit counts over the block's lanes
        int incl = tot;
#pragma unroll
        for (int d = 1; d < LPB; d <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, d, LPB);
            if (sl >= d) incl += y;
        }
        const int total = __shfl_sync(FULL, incl, LPB - 1, LPB);
        if (i >= nm) continue;  // past the frame: nothing to write

        uint32_t* slot;
        int32_t* nbits;
        if (luma) {
            slot = slots + (i * NY + g) * wwords;
            nbits = ybits + (long long)m * NY + g;
        } else if (g == NY) {
            slot = slots + (MT * NY + i) * wwords;
            nbits = ubits + m;
        } else {
            slot = slots + (MT * (NY + 1) + i) * wwords;
            nbits = vbits + m;
        }
        // pass 2: stream this lane's bits [incl - tot, incl) MSB first.
        // Whole words inside the range are this lane's alone and are
        // stored; the words at the ends are shared with the lanes
        // beside it and are ORed in.
        {
            const int o = incl - tot;
            int w = o >> 5, nb = o & 31;  // next word; bits held in cur
            uint32_t cur = 0u;
            const int w_first = nb ? w : -1;
            auto emit = [&](uint32_t word) {
                if (w < wwords) {
                    if (w == w_first) atomicOr(slot + w, word);
                    else slot[w] = word;
                }
                ++w;
            };
            auto append = [&](uint32_t bits, int n) {  // n <= 32
                if (n == 0) return;
                const uint64_t x = ((uint64_t)cur << 32) | ((uint64_t)bits << (64 - nb - n));
                nb += n;
                if (nb >= 32) {
                    emit((uint32_t)(x >> 32));
                    nb -= 32;
                    cur = (uint32_t)x;
                } else {
                    cur = (uint32_t)(x >> 32);
                }
            };
            append(dc_piece, dc_len);
            for (int jj = p0, prev = prev0, r = r0; r < r1; ++r, prev = jj, jj = next_bit(nzm, jj)) {
                uint64_t piece;
                int len;
                symbol(jj, jj - prev - 1, piece, len);
                const int hi = len > 32 ? len - 32 : 0;  // piece holds exactly len bits
                append((uint32_t)(piece >> 32), hi);
                append((uint32_t)piece, len - hi);
            }
            append(act[0] >> 5, eob_len);
            if (nb && w < wwords) atomicOr(slot + w, cur);
        }
        if (sl == 0) {
            *nbits = total;
            if (total > wwords * 32) *ovf = 1;
        }
    }
    __syncthreads();

    // ---- coalesced slot stores: the tile's rows are contiguous ----
    {
        const long long ny_w = (long long)nm * NY * wwords, nc_w = (long long)nm * wwords;
        uint32_t* yd = ys + (long long)m0 * NY * wwords;
        for (int e = tid; e < ny_w; e += NC) yd[e] = slots[e];
        uint32_t* ud = us + (long long)m0 * wwords;
        uint32_t* vd = vs + (long long)m0 * wwords;
        const uint32_t* su = slots + MT * NY * wwords;
        const uint32_t* sv = slots + MT * (NY + 1) * wwords;
        for (int e = tid; e < nc_w; e += NC) {
            ud[e] = su[e];
            vd[e] = sv[e];
        }
    }
}

// Huffman entries are packed as (code << 5) | length.
// K: bytes per MCU, NC = 64 * blocks per MCU, NY: luma blocks per MCU,
// MCU_H: raw rows per MCU, BPR: bytes per MCU row.
template <int K, int NC, int NY, int MCU_H, int BPR>
__global__ void __launch_bounds__(NC, 768 / NC) jpeg_encode_kernel(
    const uint8_t* __restrict__ frame, long long linesize,
    const float* __restrict__ wc, int n_wc_rows,
    const int32_t* __restrict__ rows, int n_rows,
    const int32_t* __restrict__ groups, const float* __restrict__ cst,
    const int32_t* __restrict__ huff,
    uint32_t* __restrict__ ys, int32_t* __restrict__ ybits,
    uint32_t* __restrict__ us, int32_t* __restrict__ ubits,
    uint32_t* __restrict__ vs, int32_t* __restrict__ vbits,
    uint8_t* __restrict__ ovf, int nmcux, int nmcu, int ri, int wwords)
{
    constexpr int BPM = NY + 2;
    constexpr int RAWS = K + RAW_PAD;
    static_assert(NC == 64 * BPM, "one column per (block, zigzag position)");
    static_assert(K == MCU_H * BPR, "MCU geometry");
    static_assert(NC == BPM * (64 / CPT) * (MT / RM), "one front-end thread per 4x4 tile");
    static_assert(MT * BPM % (NC / 32) == 0 && MT * BPM / (NC / 32) % (32 / LPB) == 0,
                  "blocks split evenly over warps and lane groups");

    extern __shared__ __align__(16) unsigned char smem[];
    const int xs_len = (n_rows > NC ? n_rows : NC) * MT;
    float* wc_s = reinterpret_cast<float*>(smem);          // [n_wc_rows][64]
    float* xs = wc_s + n_wc_rows * 64;                       // [n_rows][MT], then q
    int* qs = reinterpret_cast<int*>(xs);                    // [MT][NC]
    uint32_t* slots = reinterpret_cast<uint32_t*>(xs + xs_len);  // Y, then Cb, then Cr
    int* rows_s = reinterpret_cast<int*>(slots + MT * BPM * wwords);
    uint32_t* dc_tab = reinterpret_cast<uint32_t*>(rows_s + n_rows);  // luma[16], chroma[16]
    uint32_t* ac_tab = dc_tab + 32;                                    // luma[256], chroma[256]
    float* xprev = reinterpret_cast<float*>(ac_tab + 512);             // [n_rows]: x of the MCU before
    uint8_t* raw = reinterpret_cast<uint8_t*>(xprev + n_rows);          // [MT + 1][RAWS], 0 = MCU before
    __shared__ int grp[BPM][3];  // (row offset, Wc row offset, |S_g|)
    __shared__ int carry[3];     // DC of the MCU before the tile: last luma, Cb, Cr

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;

    // ---- once per CTA: the plan, the compact W and the Huffman tables ----
    for (int e = tid; e < n_wc_rows * 16; e += NC)
        reinterpret_cast<float4*>(wc_s)[e] = __ldg(reinterpret_cast<const float4*>(wc) + e);
    for (int e = tid; e < n_rows; e += NC) rows_s[e] = __ldg(rows + e);
    for (int e = tid; e < 544; e += NC) dc_tab[e] = (uint32_t)__ldg(huff + e);  // ac_tab follows
    if (tid < BPM * 3) grp[tid / 3][tid % 3] = __ldg(groups + tid);
    __syncthreads();

    // front-end role: group g, columns 4*c4.., MCUs 4*ms..
    const int fg = tid >> 6, c4 = tid & 15, ms = (tid >> 4) & 3;
    const int f_ro = grp[fg][0], f_wo = grp[fg][1], f_n = grp[fg][2];
    const float4 cc = __ldg(reinterpret_cast<const float4*>(cst) + fg * 16 + c4);

    // frame rows read as 32-bit words where the frame and its lines allow
    const bool words = ((reinterpret_cast<uintptr_t>(frame) | (uintptr_t)linesize) & 3) == 0;

    const int ntiles = (nmcu + MT - 1) / MT;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = tile * MT;
        const int nm = min(MT, nmcu - m0);
        const bool need_carry = m0 % ri != 0;
        const int my0 = (m0 - 1 + (m0 == 0)) / nmcux;  // MCU row of m0 - 1 (of m0 for the first tile)
        const int mx0 = m0 - 1 - my0 * nmcux;           // -1 for the first tile

        // ---- raw bytes of the MCU before the tile and of the tile: all
        // loads in flight before the first store; a warp reads one line ----
        if (words) {
            constexpr int WPR = BPR / 4, NW = (MT + 1) * K / 4;
            constexpr int IT = (NW + NC - 1) / NC;
            uint32_t v[IT];
#pragma unroll
            for (int j = 0; j < IT; ++j) {
                const int e = tid + j * NC;
                const int r = e / ((MT + 1) * WPR), rest = e - r * ((MT + 1) * WPR);
                const int i = rest / WPR - 1, c = rest - (i + 1) * WPR;
                v[j] = 0u;
                if (e < NW && i < nm && (i >= 0 || need_carry)) {
                    int mx = mx0 + 1 + i, my = my0;
                    while (mx >= nmcux) { mx -= nmcux; ++my; }
                    v[j] = __ldg(reinterpret_cast<const uint32_t*>(
                        frame + (long long)(my * MCU_H + r) * linesize + (long long)mx * BPR + 4 * c));
                }
            }
#pragma unroll
            for (int j = 0; j < IT; ++j) {
                const int e = tid + j * NC;
                const int r = e / ((MT + 1) * WPR), rest = e - r * ((MT + 1) * WPR);
                const int i = rest / WPR - 1, c = rest - (i + 1) * WPR;
                if (e < NW) *reinterpret_cast<uint32_t*>(raw + (i + 1) * RAWS + r * BPR + 4 * c) = v[j];
            }
        } else {
            for (int e = tid; e < (MT + 1) * K; e += NC) {
                const int i = e / K - 1, kk = e - (i + 1) * K;
                uint8_t b = 0;
                if (i < nm && (i >= 0 || need_carry)) {
                    int mx = mx0 + 1 + i, my = my0;
                    while (mx >= nmcux) { mx -= nmcux; ++my; }
                    const int r = kk / BPR, c = kk - r * BPR;
                    b = frame[(long long)(my * MCU_H + r) * linesize + (long long)mx * BPR + c];
                }
                raw[(i + 1) * RAWS + kk] = b;
            }
        }
        __syncthreads();

        // ---- gather: x[row][mcu] as f32, and x of the MCU before ----
#pragma unroll 4
        for (int e = tid; e < n_rows * MT; e += NC) {
            const int rk = e / MT, i = e - rk * MT;
            xs[e] = (float)raw[(i + 1) * RAWS + rows_s[rk]];
        }
        if (need_carry)
            for (int e = tid; e < n_rows; e += NC) xprev[e] = (float)raw[rows_s[e]];
        __syncthreads();

        // ---- DC predictors for a tile inside a segment: the same chain ----
        if (need_carry && lane == 0 && warp < 3) {
            const int g = NY - 1 + warp;
            const int ro = grp[g][0], wo = grp[g][1], n = grp[g][2];
            float acc = 0.f;
#pragma unroll 8
            for (int k = 0; k < n; ++k) acc = fmaf(xprev[ro + k], wc_s[(wo + k) * 64], acc);
            carry[warp] = __float2int_rn(__fsub_rn(acc, __ldg(cst + g * 64)));
        }

        // ---- front end: 4 MCUs x 4 columns per thread, ascending k ----
        float acc[RM][CPT];
#pragma unroll
        for (int a = 0; a < RM; ++a)
#pragma unroll
            for (int b = 0; b < CPT; ++b) acc[a][b] = 0.f;
        {
            const float4* wp = reinterpret_cast<const float4*>(wc_s + f_wo * 64) + c4;
            const float4* xp = reinterpret_cast<const float4*>(xs + f_ro * MT) + ms;
#pragma unroll 4
            for (int k = 0; k < f_n; ++k) {
                const float4 w = wp[k * 16];
                const float4 x = xp[k * (MT / 4)];
                const float xv[4] = {x.x, x.y, x.z, x.w};
                const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int a = 0; a < RM; ++a)
#pragma unroll
                    for (int b = 0; b < CPT; ++b) acc[a][b] = fmaf(xv[a], wv[b], acc[a][b]);
            }
        }
        __syncthreads();  // every thread is done reading x
        {
            const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
            for (int a = 0; a < RM; ++a) {
                int4 o;
                o.x = __float2int_rn(__fsub_rn(acc[a][0], cv[0]));
                o.y = __float2int_rn(__fsub_rn(acc[a][1], cv[1]));
                o.z = __float2int_rn(__fsub_rn(acc[a][2], cv[2]));
                o.w = __float2int_rn(__fsub_rn(acc[a][3], cv[3]));
                *reinterpret_cast<int4*>(qs + (ms * RM + a) * NC + fg * 64 + c4 * CPT) = o;
            }
        }
        for (int e = tid; e < MT * BPM * wwords; e += NC) slots[e] = 0u;
        __syncthreads();

        pack_tile<NC, NY>(qs, slots, dc_tab, ac_tab, carry, ys, ybits, us, ubits, vs, vbits,
                          ovf, m0, nm, ri, wwords);
        // The next tile writes raw and carry, read here only before the last
        // barrier, and clears the slots only after two more barriers.
    }
}

template <int K, int NC, int NY, int MCU_H, int BPR>
int launch(const uint8_t* f, long long linesize, const float* wc, int n_wc_rows,
           const int32_t* rows, int n_rows, const int32_t* groups, const float* c,
           const int32_t* h, uint32_t* y, int32_t* yb, uint32_t* u, int32_t* ub,
           uint32_t* v, int32_t* vb, uint8_t* o, int nmcux, int nmcu, int ri, int wwords,
           cudaStream_t st)
{
    constexpr int BPM = NY + 2;
    const size_t smem = (size_t)n_wc_rows * 64 * 4 + (size_t)(n_rows > NC ? n_rows : NC) * MT * 4
                        + (size_t)MT * BPM * wwords * 4 + (size_t)n_rows * 8 + 544 * 4
                        + (size_t)(MT + 1) * (K + RAW_PAD);
    auto kern = jpeg_encode_kernel<K, NC, NY, MCU_H, BPR>;
    // the resident CTAs the card holds for this shared memory size, set up
    // once per device and size (the host calls cost more than a 1080p launch;
    // the banded sender launches on every card of its mesh, each frame)
    static std::mutex mu;
    static int cached_cap[MAX_DEVICES] = {};
    static size_t cached_smem[MAX_DEVICES] = {};
    int dev = 0, cap = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    {
        std::lock_guard<std::mutex> lock(mu);
        if (smem != cached_smem[dev]) {
            int sms = 0, per_sm = 0;
            if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
                != cudaSuccess)
                return (int)err;
            if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
                return (int)err;
            if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NC, smem)) != cudaSuccess)
                return (int)err;
            if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
            cached_smem[dev] = smem;
            cached_cap[dev] = per_sm * sms;
        }
        cap = cached_cap[dev];
    }
    const int ntiles = (nmcu + MT - 1) / MT;
    const int grid = ntiles < cap ? ntiles : cap;
    jpeg_encode_kernel<K, NC, NY, MCU_H, BPR><<<grid, NC, smem, st>>>(f, linesize, wc, n_wc_rows, rows, n_rows, groups, c, h,
        y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords);
    return (int)cudaGetLastError();
}

// K1's per-plane entry: the whole device JPEG encode of one frame in one
// launch for the geometries without a mega matrix (4:4:4 from UYVY/YUYV,
// 4:2:2 from RGB/RGBA).  No Pallas kernel serves them: ultragrid_tpu/ops/
// jpeg_pallas.py::supports() refuses them, and the reference's XLA
// per-plane stages (ultragrid_tpu/ops/jpeg.py::JpegEncoder._make_encode)
// raise for each of them; the port adds the chroma resampling they lack
// (ops/jpeg.py::JpegEncoder.planes).  Per tile of MT MCUs:
//   1. the raw bytes of the tile and of the MCU before it to shared memory,
//      as jpeg_encode_kernel stages them;
//   2. the Y, Cb, Cr planes as float32 in the plain version's exact order
//      (plane_value), written straight into the front end's [block][k][mcu]
//      layout;
//   3. q = rint(chain - const): per block one fmaf per k over all 64 k in
//      ascending order against W = [my | mc] (dense: no support plan), the
//      order of ops/jpeg.py::_fma_chain; jpeg_encode_kernel's register tiling
//      (4 MCUs x 4 columns a thread, one 16-byte load of W and one of x per k);
//   4. pack_tile, as in jpeg_encode_kernel.
// A tile that starts inside a restart segment recomputes the DC predictors
// of the MCU before it with the same chain.  No coefficient leaves the chip.
// What bounds it on an H100: FP32 FMAs, 64 x 64 per 8x8 block (1080p UYVY
// 4:4:4: 398 M, 11.9 us at 67 TFLOP/s) against the frame read once and the
// slots written once (10.7 MB at wwords 16, 3.2 us at 3.35 TB/s).  Its
// design is K1's, so the same phases hold it below that bound: measured on
// an H100 (chip_smoke.py), 15-20% of it at 1080p and 21% at 4K.

// The JFIF colour weights of the RGB planes, rounded to float32 from the
// doubles that the plain version's tensors are made from.
constexpr float Y_R = (float)0.299, Y_G = (float)0.587, Y_B = (float)0.114;
constexpr float CB_R = (float)-0.168735892, CB_G = (float)0.331264108, CB_B = (float)0.5;
constexpr float CR_R = (float)0.5, CR_G = (float)0.418687589, CR_B = (float)-0.081312411;

// Value k (row k / 8, column k % 8) of block g (NY luma blocks, Cb, Cr) of
// one MCU's raw bytes, rounded as ops/jpeg.py::JpegEncoder.planes rounds it
// (the intrinsics keep nvcc from contracting or splitting a step).
// BPP 2: 4:4:4 from UYVY (YFIRST false) or YUYV, the bytes as floats, each
// chroma byte repeated for its two pixels, unshifted (const holds the -128).
// BPP 3/4: 4:2:2 from RGB/RGBA, y = (0.587 g (+) 0.299 r) (+) 0.114 b - 128
// with (+) a fused multiply-add, Cb/Cr from -(w_g g) fused with r then b,
// each chroma pair averaged as (a + b) * 0.5.
template <int NY, int BPP, bool YFIRST>
__device__ __forceinline__ float plane_value(const uint8_t* mcu, int g, int k)
{
    constexpr int BPR = 8 * NY * BPP;
    const uint8_t* row = mcu + (k >> 3) * BPR;
    const int c = k & 7;
    if constexpr (BPP == 2) {
        const int off = g == 0 ? 2 * c + (YFIRST ? 0 : 1) : 4 * (c >> 1) + (YFIRST ? 1 : 0) + 2 * (g - 1);
        return (float)row[off];
    } else {
        if (g < NY) {
            const uint8_t* p = row + (8 * g + c) * BPP;
            const float r = p[0], gr = p[1], b = p[2];
            return __fadd_rn(__fmaf_rn(Y_B, b, __fmaf_rn(Y_R, r, __fmul_rn(Y_G, gr))), -128.f);
        }
        const bool cb = g == NY;
        auto chroma = [&](const uint8_t* p) {
            const float r = p[0], gr = p[1], b = p[2];
            return cb ? __fmaf_rn(CB_B, b, __fmaf_rn(CB_R, r, -__fmul_rn(CB_G, gr)))
                      : __fmaf_rn(CR_B, b, __fmaf_rn(CR_R, r, -__fmul_rn(CR_G, gr)));
        };
        const uint8_t* p = row + 2 * c * BPP;
        return __fmul_rn(__fadd_rn(chroma(p), chroma(p + BPP)), 0.5f);
    }
}

// NY: luma blocks per MCU (1 for 4:4:4, an 8x8 MCU; 2 for 4:2:2, 16x8);
// BPP: bytes per pixel; YFIRST: YUYV rather than UYVY.  Huffman entries
// and outputs as jpeg_encode_kernel; w [64][128] = [my | mc], cst [128].
template <int NY, int BPP, bool YFIRST>
__global__ void __launch_bounds__(64 * (NY + 2), 768 / (64 * (NY + 2))) jpeg_plane_encode_kernel(
    const uint8_t* __restrict__ frame, long long linesize,
    const float* __restrict__ w, const float* __restrict__ cst,
    const int32_t* __restrict__ huff,
    uint32_t* __restrict__ ys, int32_t* __restrict__ ybits,
    uint32_t* __restrict__ us, int32_t* __restrict__ ubits,
    uint32_t* __restrict__ vs, int32_t* __restrict__ vbits,
    uint8_t* __restrict__ ovf, int nmcux, int nmcu, int ri, int wwords)
{
    constexpr int BPM = NY + 2, NC = 64 * BPM, MCU_H = 8, BPR = 8 * NY * BPP, K = MCU_H * BPR;
    constexpr int RAWS = K + RAW_PAD;
    static_assert(NC == BPM * (64 / CPT) * (MT / RM), "one front-end thread per 4x4 tile");

    extern __shared__ __align__(16) unsigned char smem[];
    float* w_s = reinterpret_cast<float*>(smem);                       // [64][128]: my | mc
    float* xs = w_s + 64 * 128;                                         // [BPM][64][MT], then q
    int* qs = reinterpret_cast<int*>(xs);                               // [MT][NC]
    uint32_t* slots = reinterpret_cast<uint32_t*>(xs + NC * MT);        // Y, then Cb, then Cr
    uint32_t* dc_tab = slots + MT * BPM * wwords;                       // luma[16], chroma[16]
    uint32_t* ac_tab = dc_tab + 32;                                     // luma[256], chroma[256]
    float* xprev = reinterpret_cast<float*>(ac_tab + 512);              // [3][64]: last luma, Cb, Cr before
    uint8_t* raw = reinterpret_cast<uint8_t*>(xprev + 3 * 64);          // [MT + 1][RAWS], 0 = MCU before
    __shared__ int carry[3];  // DC of the MCU before the tile: last luma, Cb, Cr

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;

    // ---- once per CTA: W and the Huffman tables ----
    for (int e = tid; e < 64 * 128 / 4; e += NC)
        reinterpret_cast<float4*>(w_s)[e] = __ldg(reinterpret_cast<const float4*>(w) + e);
    for (int e = tid; e < 544; e += NC) dc_tab[e] = (uint32_t)__ldg(huff + e);  // ac_tab follows
    __syncthreads();

    // front-end role: block g, columns 4*c4.., MCUs 4*ms..; luma blocks
    // take my (columns 0-63 of W), chroma blocks mc (64-127)
    const int fg = tid >> 6, c4 = tid & 15, ms = (tid >> 4) & 3;
    const int f_col = fg < NY ? 0 : 64;
    const float4 cc = __ldg(reinterpret_cast<const float4*>(cst + f_col) + c4);

    // frame rows read as 32-bit words where the frame and its lines allow
    const bool words = ((reinterpret_cast<uintptr_t>(frame) | (uintptr_t)linesize) & 3) == 0;

    const int ntiles = (nmcu + MT - 1) / MT;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = tile * MT;
        const int nm = min(MT, nmcu - m0);
        const bool need_carry = m0 % ri != 0;
        const int my0 = (m0 - 1 + (m0 == 0)) / nmcux;  // MCU row of m0 - 1 (of m0 for the first tile)
        const int mx0 = m0 - 1 - my0 * nmcux;           // -1 for the first tile

        // ---- raw bytes of the MCU before the tile and of the tile: all
        // loads in flight before the first store; a warp reads one line ----
        if (words) {
            constexpr int WPR = BPR / 4, NW = (MT + 1) * K / 4;
            constexpr int IT = (NW + NC - 1) / NC;
            uint32_t v[IT];
#pragma unroll
            for (int j = 0; j < IT; ++j) {
                const int e = tid + j * NC;
                const int r = e / ((MT + 1) * WPR), rest = e - r * ((MT + 1) * WPR);
                const int i = rest / WPR - 1, c = rest - (i + 1) * WPR;
                v[j] = 0u;
                if (e < NW && i < nm && (i >= 0 || need_carry)) {
                    int mx = mx0 + 1 + i, my = my0;
                    while (mx >= nmcux) { mx -= nmcux; ++my; }
                    v[j] = __ldg(reinterpret_cast<const uint32_t*>(
                        frame + (long long)(my * MCU_H + r) * linesize + (long long)mx * BPR + 4 * c));
                }
            }
#pragma unroll
            for (int j = 0; j < IT; ++j) {
                const int e = tid + j * NC;
                const int r = e / ((MT + 1) * WPR), rest = e - r * ((MT + 1) * WPR);
                const int i = rest / WPR - 1, c = rest - (i + 1) * WPR;
                if (e < NW) *reinterpret_cast<uint32_t*>(raw + (i + 1) * RAWS + r * BPR + 4 * c) = v[j];
            }
        } else {
            for (int e = tid; e < (MT + 1) * K; e += NC) {
                const int i = e / K - 1, kk = e - (i + 1) * K;
                uint8_t b = 0;
                if (i < nm && (i >= 0 || need_carry)) {
                    int mx = mx0 + 1 + i, my = my0;
                    while (mx >= nmcux) { mx -= nmcux; ++my; }
                    const int r = kk / BPR, c = kk - r * BPR;
                    b = frame[(long long)(my * MCU_H + r) * linesize + (long long)mx * BPR + c];
                }
                raw[(i + 1) * RAWS + kk] = b;
            }
        }
        __syncthreads();

        // ---- planes: x[block][k][mcu] as f32, and x of the MCU before ----
#pragma unroll 4
        for (int e = tid; e < NC * MT; e += NC) {
            const int gk = e / MT, i = e - gk * MT;
            xs[e] = plane_value<NY, BPP, YFIRST>(raw + (i + 1) * RAWS, gk >> 6, gk & 63);
        }
        if (need_carry)
            for (int e = tid; e < 3 * 64; e += NC) xprev[e] = plane_value<NY, BPP, YFIRST>(raw, NY - 1 + (e >> 6), e & 63);
        __syncthreads();

        // ---- DC predictors for a tile inside a segment: the same chain ----
        if (need_carry && lane == 0 && warp < 3) {
            const int col = warp == 0 ? 0 : 64;  // the last luma block, Cb, Cr
            float acc = 0.f;
#pragma unroll 8
            for (int k = 0; k < 64; ++k) acc = fmaf(xprev[warp * 64 + k], w_s[k * 128 + col], acc);
            carry[warp] = __float2int_rn(__fsub_rn(acc, __ldg(cst + col)));
        }

        // ---- front end: 4 MCUs x 4 columns per thread, ascending k ----
        float acc[RM][CPT];
#pragma unroll
        for (int a = 0; a < RM; ++a)
#pragma unroll
            for (int b = 0; b < CPT; ++b) acc[a][b] = 0.f;
        {
            const float4* wp = reinterpret_cast<const float4*>(w_s + f_col) + c4;
            const float4* xp = reinterpret_cast<const float4*>(xs + fg * 64 * MT) + ms;
#pragma unroll 4
            for (int k = 0; k < 64; ++k) {
                const float4 wk = wp[k * 32];
                const float4 x = xp[k * (MT / 4)];
                const float xv[4] = {x.x, x.y, x.z, x.w};
                const float wv[4] = {wk.x, wk.y, wk.z, wk.w};
#pragma unroll
                for (int a = 0; a < RM; ++a)
#pragma unroll
                    for (int b = 0; b < CPT; ++b) acc[a][b] = fmaf(xv[a], wv[b], acc[a][b]);
            }
        }
        __syncthreads();  // every thread is done reading x
        {
            const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
            for (int a = 0; a < RM; ++a) {
                int4 o;
                o.x = __float2int_rn(__fsub_rn(acc[a][0], cv[0]));
                o.y = __float2int_rn(__fsub_rn(acc[a][1], cv[1]));
                o.z = __float2int_rn(__fsub_rn(acc[a][2], cv[2]));
                o.w = __float2int_rn(__fsub_rn(acc[a][3], cv[3]));
                *reinterpret_cast<int4*>(qs + (ms * RM + a) * NC + fg * 64 + c4 * CPT) = o;
            }
        }
        for (int e = tid; e < MT * BPM * wwords; e += NC) slots[e] = 0u;
        __syncthreads();

        pack_tile<NC, NY>(qs, slots, dc_tab, ac_tab, carry, ys, ybits, us, ubits, vs, vbits,
                          ovf, m0, nm, ri, wwords);
        // The next tile writes raw and carry, read here only before the last
        // barrier, and clears the slots only after two more barriers.
    }
}

template <int NY, int BPP, bool YFIRST>
int launch_plane(const uint8_t* f, long long linesize, const float* w, const float* c,
                 const int32_t* h, uint32_t* y, int32_t* yb, uint32_t* u, int32_t* ub,
                 uint32_t* v, int32_t* vb, uint8_t* o, int nmcux, int nmcu, int ri, int wwords,
                 cudaStream_t st)
{
    constexpr int BPM = NY + 2, NC = 64 * BPM, K = 64 * NY * BPP;
    const size_t smem = (size_t)64 * 128 * 4 + (size_t)NC * MT * 4 + (size_t)MT * BPM * wwords * 4
                        + 544 * 4 + 3 * 64 * 4 + (size_t)(MT + 1) * (K + RAW_PAD);
    auto kern = jpeg_plane_encode_kernel<NY, BPP, YFIRST>;
    // the resident CTAs the card holds for this shared memory size, set up
    // once per device and size, as launch() does
    static std::mutex mu;
    static int cached_cap[MAX_DEVICES] = {};
    static size_t cached_smem[MAX_DEVICES] = {};
    int dev = 0, cap = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    {
        std::lock_guard<std::mutex> lock(mu);
        if (smem != cached_smem[dev]) {
            int sms = 0, per_sm = 0;
            if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
                != cudaSuccess)
                return (int)err;
            if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
                return (int)err;
            if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NC, smem)) != cudaSuccess)
                return (int)err;
            if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
            cached_smem[dev] = smem;
            cached_cap[dev] = per_sm * sms;
        }
        cap = cached_cap[dev];
    }
    const int ntiles = (nmcu + MT - 1) / MT;
    const int grid = ntiles < cap ? ntiles : cap;
    kern<<<grid, NC, smem, st>>>(f, linesize, w, c, h, y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords);
    return (int)cudaGetLastError();
}

}  // namespace

// layout: 0 = 4:2:2 YUV (16x8 MCU), 1 = 4:2:0 YUV (16x16), 2 = RGB 4:4:4,
// 3 = RGBA 4:4:4.  wc [n_wc_rows, 64] f32, rows [n_rows] i32, groups
// [blocks per MCU][3] i32 = (offset in rows, offset in wc rows, |S_g|), the
// plan of ops/jpeg.py::support_plan.  ovf is one byte, set to 1 on overflow.
// Returns the first CUDA error of the set-up or the launch, else 0.
extern "C" int ug_jpeg_encode(
    const void* frame, long long linesize, const void* wc, int n_wc_rows,
    const void* rows, int n_rows, const void* groups, const void* cst,
    const void* huff, void* ys, void* ybits, void* us, void* ubits, void* vs,
    void* vbits, void* ovf, int layout, int nmcux, int nmcu, int ri,
    int wwords, void* stream)
{
    if (nmcu <= 0 || ri <= 0 || nmcux <= 0 || wwords <= 0 || n_wc_rows < 0 || n_rows < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* f = static_cast<const uint8_t*>(frame);
    const float* w = static_cast<const float*>(wc);
    const int32_t* r = static_cast<const int32_t*>(rows);
    const int32_t* g = static_cast<const int32_t*>(groups);
    const float* c = static_cast<const float*>(cst);
    const int32_t* h = static_cast<const int32_t*>(huff);
    uint32_t* y = static_cast<uint32_t*>(ys);
    uint32_t* u = static_cast<uint32_t*>(us);
    uint32_t* v = static_cast<uint32_t*>(vs);
    int32_t* yb = static_cast<int32_t*>(ybits);
    int32_t* ub = static_cast<int32_t*>(ubits);
    int32_t* vb = static_cast<int32_t*>(vbits);
    uint8_t* o = static_cast<uint8_t*>(ovf);
    switch (layout) {
    case 0:
        return launch<256, 256, 2, 8, 32>(f, linesize, w, n_wc_rows, r, n_rows, g, c, h,
                                          y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords, st);
    case 1:
        return launch<512, 384, 4, 16, 32>(f, linesize, w, n_wc_rows, r, n_rows, g, c, h,
                                           y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords, st);
    case 2:
        return launch<192, 192, 1, 8, 24>(f, linesize, w, n_wc_rows, r, n_rows, g, c, h,
                                          y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords, st);
    case 3:
        return launch<256, 192, 1, 8, 32>(f, linesize, w, n_wc_rows, r, n_rows, g, c, h,
                                          y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// K1's per-plane entry.  layout: 0 = 4:4:4 from UYVY (8x8 MCU), 1 = 4:4:4
// from YUYV, 2 = 4:2:2 from RGB (16x8), 3 = 4:2:2 from RGBA.  w [64, 128]
// f32 = [my | mc] and cst [128] f32 of ops/jpeg.py::JpegEncoder.
// _build_plane_matrices; huff and the outputs as ug_jpeg_encode.  Returns
// the first CUDA error of the set-up or the launch, else 0.
extern "C" int ug_jpeg_plane_encode(
    const void* frame, long long linesize, const void* w, const void* cst, const void* huff,
    void* ys, void* ybits, void* us, void* ubits, void* vs, void* vbits, void* ovf,
    int layout, int nmcux, int nmcu, int ri, int wwords, void* stream)
{
    if (nmcu <= 0 || ri <= 0 || nmcux <= 0 || wwords <= 0 || wwords > 64) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* f = static_cast<const uint8_t*>(frame);
    const float* ww = static_cast<const float*>(w);
    const float* c = static_cast<const float*>(cst);
    const int32_t* h = static_cast<const int32_t*>(huff);
    uint32_t* y = static_cast<uint32_t*>(ys);
    uint32_t* u = static_cast<uint32_t*>(us);
    uint32_t* v = static_cast<uint32_t*>(vs);
    int32_t* yb = static_cast<int32_t*>(ybits);
    int32_t* ub = static_cast<int32_t*>(ubits);
    int32_t* vb = static_cast<int32_t*>(vbits);
    uint8_t* o = static_cast<uint8_t*>(ovf);
    switch (layout) {
    case 0:
        return launch_plane<1, 2, false>(f, linesize, ww, c, h, y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords, st);
    case 1:
        return launch_plane<1, 2, true>(f, linesize, ww, c, h, y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords, st);
    case 2:
        return launch_plane<2, 3, false>(f, linesize, ww, c, h, y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords, st);
    case 3:
        return launch_plane<2, 4, false>(f, linesize, ww, c, h, y, yb, u, ub, v, vb, o, nmcux, nmcu, ri, wwords, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
