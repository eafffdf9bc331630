// K2: LDGM parity of the sender's slot container, in one launch; with the
// staircase off, the row XORs of the receiver's erasure peel.
//
// Replaces ultragrid_tpu/ops/fec.py::make_gf2_parity_pallas (the Pallas TPU
// kernel) and the container assembly and staircase around it
// (models/encode.py, ops/fec.py::apply_staircase).  Parity row i = XOR of the
// container rows that row i of the mask selects; with STAIR (a template
// flag, `stair` at the C entry), then the staircase: the XOR of parity rows
// 0..i.  The container is never built: it is up to six parts (the JPEG slot
// words and bit counts), part p filling rows row0[p] .. row0[p+1]-1 of psw
// words each, zero past its own words.
// The mask is static per session and arrives as per-row member lists (CSR:
// row_ptr[m + 1], cols[nnz]) built once on the host.  The peel
// (ops/fec.py::LdgmSession.decode_device) passes one part, the [k + m, psw]
// symbol block, and the full check matrix (m rows over k + m columns) with
// the staircase off.
// A frame axis (blockIdx.y, the template flag FRAMES) runs B independent
// containers in one launch: each part holds its B frames back to back, so
// part p of frame f starts words[p] * f words after part p of frame 0, and
// frame f's parity is out[f] ([B, m, psw]) — the layout of the batched
// sender (models/encode.py::BatchedJpegLdgmPipeline), whose one K1 launch
// over B stacked frames writes each part frame after frame.  B = 1 runs
// the instantiation without the flag, the single-frame sender's code as it
// was.
//
// What bounds it on an H100: memory.  The needed traffic is one read of the
// parts plus one write of the parity (39 MB at 8K, 11.6 us at 3.35 TB/s);
// each data word feeds about c parity rows, one XOR each.  Design: a CTA
// owns a strip of SW column words.  It loads every container word of the
// strip once into shared memory (16 bytes a thread where the parts are
// aligned), computes the m raw parity rows from shared memory (a thread per
// column and chunk of rows), then either one thread per column runs the
// staircase down the rows in a register and stores each row, or, with the
// staircase off, all threads store the raw rows coalesced.
//
// Tall check matrices (the peel of k = m = 1500, c = 8: 3000 container rows,
// 1500 parity rows, about 15,000 members) leave little shared memory for the
// strip, so strips go down to 8 and 4 words.  Where even a 4-word strip with
// its parity rows, row table and member lists does not fit, the TALL variant
// keeps only the data strip in shared memory: it reads the member lists from
// global memory (L1 serves their reuse), finds each row's part as it loads,
// and stores the raw parity rows straight to `out` (the staircase, if on,
// then runs down `out` itself).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PARTS = 6;
constexpr size_t MAX_SMEM = 200 * 1024;

struct Parts {
    const uint32_t* ptr[MAX_PARTS];
    long long words[MAX_PARTS];  // words of the part in one frame
    int row0[MAX_PARTS + 1];  // row0[nparts] = container rows
    int nparts;
};

// where container row r (of frame blockIdx.y with FRAMES) starts, and how
// many of its part's words remain from there (compile-time part indices: no
// run-time indexing of `parts`)
template <bool FRAMES>
__device__ __forceinline__ void row_source(const Parts& parts, long long psw, int r,
                                           const uint32_t*& src, long long& lim)
{
    const uint32_t* s = parts.ptr[0];
    long long pw = parts.words[0];
    int r0 = 0;
#pragma unroll
    for (int q = 1; q < MAX_PARTS; ++q)
        if (q < parts.nparts && r >= parts.row0[q]) {
            s = parts.ptr[q];
            pw = parts.words[q];
            r0 = parts.row0[q];
        }
    const long long off = (long long)(r - r0) * psw;
    src = s + off;
    if constexpr (FRAMES) src += pw * blockIdx.y;
    lim = pw - off;
}

template <int SW, bool TALL, bool STAIR, bool FRAMES>
__global__ void __launch_bounds__(THREADS) gf2_parity_kernel(
    const Parts parts, int rows, long long psw, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ cols, int m, int nnz, int vec, uint32_t* __restrict__ out)
{
    static_assert(THREADS % SW == 0 && SW % 4 == 0, "strip geometry");
    extern __shared__ __align__(16) uint32_t sm[];
    uint32_t* data = sm;                                                    // [rows][SW]
    // the default layout goes on: parity rows, row table, member lists
    uint32_t* par = data + rows * SW;                                       // [m][SW]
    const uint32_t** rsrc = reinterpret_cast<const uint32_t**>(par + m * SW);  // [rows]: row start
    long long* rlim = reinterpret_cast<long long*>(rsrc + rows);           // [rows]: words from it
    int* rp = reinterpret_cast<int*>(rlim + rows);                          // [m + 1]
    int* cs = rp + m + 1;                                                   // [nnz]
    const long long c0 = (long long)blockIdx.x * SW;
    const int tid = threadIdx.x;
    if constexpr (FRAMES) out += (long long)blockIdx.y * m * psw;  // this frame's parity

    if constexpr (!TALL) {
        for (int e = tid; e <= m; e += THREADS) rp[e] = __ldg(row_ptr + e);
        for (int e = tid; e < nnz; e += THREADS) cs[e] = __ldg(cols + e);
        for (int r = tid; r < rows; r += THREADS) row_source<FRAMES>(parts, psw, r, rsrc[r], rlim[r]);
        __syncthreads();
    }

    // ---- the strip of every container row, each word read once; BATCH
    // loads of a thread in flight before its first store ----
    constexpr int Q = SW / 4, BATCH = 8;
    for (int e0 = tid; e0 < rows * Q; e0 += THREADS * BATCH) {
        uint4 v[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int e = e0 + b * THREADS;
            v[b] = make_uint4(0u, 0u, 0u, 0u);
            if (e >= rows * Q) continue;
            const int r = e / Q, c = (e - r * Q) * 4;
            const uint32_t* rs;
            long long rl;
            if constexpr (TALL) {
                row_source<FRAMES>(parts, psw, r, rs, rl);
            } else {
                rs = rsrc[r];
                rl = rlim[r];
            }
            const uint32_t* src = rs + c0 + c;
            const long long lim = rl - c0 - c;  // words of the part from src on
            if (vec && c0 + c + 3 < psw && lim > 3) {
                v[b] = __ldg(reinterpret_cast<const uint4*>(src));
            } else {
                uint32_t t[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) t[j] = (c0 + c + j < psw && j < lim) ? __ldg(src + j) : 0u;
                v[b] = make_uint4(t[0], t[1], t[2], t[3]);
            }
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int e = e0 + b * THREADS;
            if (e < rows * Q) {
                const int r = e / Q, c = (e - r * Q) * 4;
                *reinterpret_cast<uint4*>(data + r * SW + c) = v[b];
            }
        }
    }
    __syncthreads();

    // ---- raw parity rows: thread (column, chunk of rows) ----
    constexpr int CH = THREADS / SW;
    const int col = tid % SW, ch = tid / SW;
    const int rpc = (m + CH - 1) / CH;
    const int i1 = min(m, (ch + 1) * rpc);
    for (int i = ch * rpc; i < i1; ++i) {
        uint32_t acc = 0;
        if constexpr (TALL) {
            const int e1 = __ldg(row_ptr + i + 1);
            for (int e = __ldg(row_ptr + i); e < e1; ++e) acc ^= data[__ldg(cols + e) * SW + col];
            if (c0 + col < psw) out[(long long)i * psw + c0 + col] = acc;
        } else {
            for (int e = rp[i]; e < rp[i + 1]; ++e) acc ^= data[cs[e] * SW + col];
            par[i * SW + col] = acc;
        }
    }
    __syncthreads();

    // ---- store: the staircase down the rows, one thread per column, or
    // the raw rows by all threads ----
    if constexpr (STAIR) {
        if (tid < SW && c0 + tid < psw) {
            uint32_t run = 0;
            for (int i = 0; i < m; ++i) {
                uint32_t* o = out + (long long)i * psw + c0 + tid;
                if constexpr (TALL) {
                    run ^= *o;  // this CTA's own store of the raw row, visible after the barrier
                } else {
                    run ^= par[i * SW + tid];
                }
                *o = run;
            }
        }
    } else if constexpr (!TALL) {
        for (int e = tid; e < m * SW; e += THREADS) {
            const int i = e / SW, c = e - i * SW;
            if (c0 + c < psw) out[(long long)i * psw + c0 + c] = par[e];
        }
    }
}

size_t smem_bytes(int sw, int rows, int m, int nnz, bool tall)
{
    if (tall) return (size_t)rows * sw * 4;
    return (size_t)(rows + m) * sw * 4 + (size_t)rows * 16 + (size_t)(m + 1 + nnz) * 4;
}

template <int SW, bool TALL, bool STAIR, bool FRAMES>
int launch(const Parts& parts, int nframes, long long psw, const int32_t* row_ptr, const int32_t* cols,
           int m, int nnz, int vec, uint32_t* out, cudaStream_t st)
{
    const int rows = parts.row0[parts.nparts];
    const size_t smem = smem_bytes(SW, rows, m, nnz, TALL);
    const cudaError_t err = cudaFuncSetAttribute(gf2_parity_kernel<SW, TALL, STAIR, FRAMES>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((psw + SW - 1) / SW), (unsigned)nframes);
    gf2_parity_kernel<SW, TALL, STAIR, FRAMES><<<grid, THREADS, smem, st>>>(parts, rows, psw, row_ptr, cols,
                                                                           m, nnz, vec, out);
    return (int)cudaGetLastError();
}

template <bool TALL, bool STAIR, bool FRAMES>
int launch_sw(int sw, const Parts& parts, int nframes, long long psw, const int32_t* row_ptr,
              const int32_t* cols, int m, int nnz, int vec, uint32_t* out, cudaStream_t st)
{
    switch (sw) {
    case 64: return launch<64, TALL, STAIR, FRAMES>(parts, nframes, psw, row_ptr, cols, m, nnz, vec, out, st);
    case 32: return launch<32, TALL, STAIR, FRAMES>(parts, nframes, psw, row_ptr, cols, m, nnz, vec, out, st);
    case 16: return launch<16, TALL, STAIR, FRAMES>(parts, nframes, psw, row_ptr, cols, m, nnz, vec, out, st);
    case 8: return launch<8, TALL, STAIR, FRAMES>(parts, nframes, psw, row_ptr, cols, m, nnz, vec, out, st);
    default: return launch<4, TALL, STAIR, FRAMES>(parts, nframes, psw, row_ptr, cols, m, nnz, vec, out, st);
    }
}

}  // namespace

// ptrs, words: host arrays [nparts] of device addresses and words per frame
// (each part holds nframes >= 1 frames back to back); row0: host array
// [nparts + 1] of first container rows.  row_ptr
// [m + 1] and cols [nnz] on the device; cols index container rows.  stair:
// 1 to apply the staircase, 0 for the raw rows.  out [nframes, m, psw] u32.
// The strip width is the widest of 64, 32, 16, 8, 4 words whose shared
// memory fits and that still gives every SM a strip (counting the frames);
// the TALL variant only where no width fits the default layout.  Returns
// the first CUDA error of the set-up or the launch, else 0.
extern "C" int ug_gf2_parity(const void* ptrs, const void* words, const void* row0, int nparts,
                             int nframes, long long psw, const void* row_ptr, const void* cols, int m,
                             int nnz, int stair, void* out, void* stream)
{
    if (nparts < 1 || nparts > MAX_PARTS || nframes < 1 || nframes > 65535 || m <= 0 || psw <= 0 ||
        nnz < 0)
        return (int)cudaErrorInvalidValue;
    Parts parts;
    const long long* p = static_cast<const long long*>(ptrs);
    const long long* w = static_cast<const long long*>(words);
    const int* r0 = static_cast<const int*>(row0);
    int vec = psw % 4 == 0;
    for (int i = 0; i < MAX_PARTS; ++i) {
        parts.ptr[i] = i < nparts ? reinterpret_cast<const uint32_t*>(p[i]) : nullptr;
        parts.words[i] = i < nparts ? w[i] : 0;
        if (i < nparts && (p[i] % 16 || (nframes > 1 && w[i] % 4))) vec = 0;
    }
    for (int i = 0; i <= MAX_PARTS; ++i) parts.row0[i] = r0[i < nparts ? i : nparts];
    parts.nparts = nparts;
    const int rows = r0[nparts];
    if (rows <= 0) return (int)cudaErrorInvalidValue;

    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    int sw = 0;
    bool tall = false;
    for (int t = 0; t < 2 && sw == 0; ++t) {
        for (int cand = 64; cand >= 4; cand /= 2) {
            if (smem_bytes(cand, rows, m, nnz, t == 1) > MAX_SMEM) continue;
            sw = cand;
            tall = t == 1;
            if ((psw + cand - 1) / cand * nframes >= sms) break;
        }
    }
    if (sw == 0) return (int)cudaErrorInvalidValue;  // even a 4-word strip of the rows is too tall

    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* rp = static_cast<const int32_t*>(row_ptr);
    const int32_t* cs = static_cast<const int32_t*>(cols);
    uint32_t* o = static_cast<uint32_t*>(out);
    if (nframes > 1) {
        if (tall)
            return stair ? launch_sw<true, true, true>(sw, parts, nframes, psw, rp, cs, m, nnz, vec, o, st)
                         : launch_sw<true, false, true>(sw, parts, nframes, psw, rp, cs, m, nnz, vec, o, st);
        return stair ? launch_sw<false, true, true>(sw, parts, nframes, psw, rp, cs, m, nnz, vec, o, st)
                     : launch_sw<false, false, true>(sw, parts, nframes, psw, rp, cs, m, nnz, vec, o, st);
    }
    if (tall)
        return stair ? launch_sw<true, true, false>(sw, parts, 1, psw, rp, cs, m, nnz, vec, o, st)
                     : launch_sw<true, false, false>(sw, parts, 1, psw, rp, cs, m, nnz, vec, o, st);
    return stair ? launch_sw<false, true, false>(sw, parts, 1, psw, rp, cs, m, nnz, vec, o, st)
                 : launch_sw<false, false, false>(sw, parts, 1, psw, rp, cs, m, nnz, vec, o, st);
}
