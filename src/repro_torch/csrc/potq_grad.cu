// K2 and K3 on Hopper: the MF-MAC backward (paper Algorithm 1, lines 13-15),
// on the FP64 tensor cores.
//
//   pre-pass  Gq = PoT(G * 2^-beta_g), bf16, scaled domain (once per backward)
//   K2        dA = Gq . Wq^T   (M,N) x (K,N)^T -> (M,K), PRC epilogue
//   K3        dW = Aq^T . Gq   (M,K)^T x (M,N) -> (K,N)
//
// Replace the Pallas TPU kernels repro/kernels/potq_grad.py
// `_grad_da_kernel` (launcher `grad_da_padded`) and `_grad_dw_kernel`
// (launcher `grad_dw_padded`).  Those quantize G in VMEM on load; here a
// small elementwise pre-pass (`grad_g_quantize_kernel`) rounds G once per
// backward, g * 2^-beta_g to the nearest PoT with emax_g (bits_g, or
// bits_g_last into the LM head), and writes it as bf16, which holds every
// PoT with |e| <= 15 exactly.  K2 and K3 both read that buffer; the output
// is dequantized once by 2^beta_g.  Wq is read in its (K,N) layout and Aq
// in its (M,K) layout: no transposed copies.
//
// Numeric spec (repro_torch/kernels/ref.py): the contraction axis (N for
// dA, M for dW) is cut into canonical 128-wide chunks; each chunk's
// partial is the EXACT sum of its PoT products, rounded once to f32
// (__double2float_rn), and the partials are left-folded in f32 in
// ascending chunk order.  Why the tensor cores keep the bits: one chunk's
// products lie on a lattice of 2*emax_x + 2*emax_y + 8 <= 53 bits (52 at
// the head's 6 x 5 pair), so every partial sum of them is a representable
// double and every IEEE fp64 operation on them is exact, in any order.
// `mma.sync ... .f64` does IEEE fp64 multiply-adds, so fragment
// accumulators that cover one chunk (k-steps of 8, accumulated across the
// chunk's slices) hold the exact chunk sum; at each chunk
// boundary and at the ragged end every accumulator is rounded once and
// added to an f32 running sum.  One block owns an output tile and walks
// the whole contraction in order: no split-K, no atomics.  K3's chunk runs
// over M, so it needs all of Aq on one activation scale (the wrapper
// refuses per-sample scales).
//
// PRC epilogue of K2: dA is zeroed where |a| > clip_t, and the dgamma
// rows sum where(clipped, dA_raw * sign(a), 0) over K.  Those are
// arbitrary f32 values, so the order is the spec's: inside a 128-wide K
// chunk a halves fold in fp64 (x[:64] + x[64:], then [:32] + [32:], ...),
// rounded once; then an f32 left fold over chunks.  The block's f32 sums
// live in shared memory, so the epilogue reads the finished 128 x 128
// tile row by row: one warp per row, a lane holding columns
// {l, l+32, l+64, l+96}; (c0 + c2) + (c1 + c3) is the first two halves
// steps and a __shfl_xor butterfly (16, 8, 4, 2, 1) the last five, which
// are the very same adds.  The chunk sums land in a (chunks, M) scratch,
// and `grad_da_rows_fold_kernel` folds them left per row.
//
// `start`: K2's fold continued across the ranks of a split contraction
// (tensor-parallel training, parallel/collectives.py ordered_fold).  A
// column-parallel linear's dA contracts over its N, which the model ranks
// split at whole 128-chunks in rank order: rank r begins its f32 running
// sums at rank r-1's (block_product's `start`), so the chain adds one
// rank's chunk sums in one rank's order, bit for bit.  A rank that is not
// last writes the raw running sums (`raw`: no dequant, no epilogue); the
// last dequantizes and runs the PRC epilogue on the finished dA.  A
// row-parallel linear's K is split instead: its dA is local, and the
// dgamma rows' left fold over K chunks continues from the previous rank's
// (M,) sums (`rows_start` of the fold kernel).
//
// Design (the product core is block_product in fp64_mma.cuh, shared with
// K1).  Block tile 128 x 128 outputs (K2: 128 rows of M x one 128-wide
// K chunk; K3: 128 rows of K x 128 of N), 256 threads = 8 warps in 2 x 4,
// warp tile 64 x 32 = 4 x 4 MMAs of m16n8k8; 64 fp64 accumulators (128
// registers) a thread.  The
// contraction walks in slices of 32 through a ring of 3 bf16 stages in
// dynamic shared memory, filled by 16-byte cp.async (zero-filled past the
// ragged edge) while the tensor cores work on the slice before.  Each
// slice is converted once per block into fp64 shared tiles, so a converted
// operand feeds 128 FMAs of the block; F2F does it (building the doubles
// by integer ops, and double-buffered fp64 half-slices that overlap the
// conversion with the MMAs, both measured slower).  The fp64 tiles are
// padded (row stride = 4 mod 16 doubles) so fragment loads are free of
// bank conflicts, and the conversion's stores are rotated so they are
// too; the f32 running sums (128 x 136 floats) likewise.  Operands whose
// rows are not 16-byte multiples (a leading dimension not a multiple of 8)
// take the same kernel with masked scalar loads.  Shared memory 188 KB
// (K2) / 182 KB (K3), one block of 256 threads per SM; ptxas (CUDA 12,
// sm_90a) gives K2 and K3 220-222 registers and no spills (chip_smoke.py
// phase 2 prints it for every build).
//
// What bounds them on an H100: 2*M*N*K operations.  Against the bf16
// tensor cores (989 TFLOP/s) that is 9.75 ms per olmo-1b training step
// each; the datapath here is the FP64 tensor cores, 67 TFLOP/s, whose
// bound is 144 ms per step each.  The bytes (G f32 once, Gq bf16 written
// and read twice, Wq, Aq, a, dA, dW) are a few ms.
//
// Plain C interface, loaded with ctypes.  Returns cudaGetLastError().

#include "fp64_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Pre-pass: Gq = PoT(G * 2^-beta_g) as bf16, elementwise, grid-stride.
// ---------------------------------------------------------------------------
template <bool VEC4>
__global__ void __launch_bounds__(256)
grad_g_quantize_kernel(const float* __restrict__ G, const float* __restrict__ scal,
                       __nv_bfloat16* __restrict__ Gq, long long n, int emax_g) {
    const float sg = scal[0];
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (VEC4) {
        const float4* g4 = reinterpret_cast<const float4*>(G);
        __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(Gq);
        for (; i < n / 4; i += stride) {
            const float4 v = g4[i];
            q2[2 * i] = __floats2bfloat162_rn(quantize_pot(v.x * sg, emax_g),
                                              quantize_pot(v.y * sg, emax_g));
            q2[2 * i + 1] = __floats2bfloat162_rn(quantize_pot(v.z * sg, emax_g),
                                                  quantize_pot(v.w * sg, emax_g));
        }
    } else {
        for (; i < n; i += stride) Gq[i] = __float2bfloat16_rn(quantize_pot(G[i] * sg, emax_g));
    }
}

// ---------------------------------------------------------------------------
// K2: dA = Gq . Wq^T over N.  X = Gq (M x N, rows along N), Y = Wq^T with
// Wq (K x N) rows along N.  Block (x: 128-wide K chunk, y: 128 rows of M).
// ---------------------------------------------------------------------------
// start: null or the (M, K) f32 running sums to continue; raw: write the
// running sums as they are (a rank before the last of a chain; no PRC).
template <bool PRC, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
grad_da_kernel(const uint16_t* __restrict__ Gq, const uint16_t* __restrict__ W,
               const float* __restrict__ A, const float* __restrict__ scal,
               const float* __restrict__ start, float* __restrict__ dA,
               float* __restrict__ part, int M, int N, int K, int raw) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int m0 = blockIdx.y * BT, k0 = blockIdx.x * BT;
    block_product<true, true, VEC>(Operand{Gq, N, M, N}, Operand{W, N, K, N}, m0, k0, smem,
                                   nullptr, 0, 0, start, K);
    const float* acc = reinterpret_cast<const float*>(
        reinterpret_cast<const double*>(smem) + 2 * tile_doubles(true));

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float deq = raw ? 1.0f : scal[1];
    float clip = 0.0f;
    if (PRC) clip = scal[2];
    for (int rr = 0; rr < BT / 8; ++rr) {
        const int r = warp * (BT / 8) + rr;
        const int gr = m0 + r;  // uniform across the warp
        if (gr >= M) break;
        float c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = lane + 32 * j, gc = k0 + col;
            float v = acc[r * ACC_LD + col] * deq;  // exact 2^beta_g dequant (raw: x 1)
            c[j] = 0.0f;
            if (gc < K) {
                if (PRC) {
                    const float av = A[(size_t)gr * K + gc];
                    if (fabsf(av) > clip) {
                        const float sgn = (float)((av > 0.0f) - (av < 0.0f));
                        c[j] = v * sgn;
                        v = 0.0f;
                    }
                }
                dA[(size_t)gr * K + gc] = v;
            }
        }
        if (PRC) {
            double s = ((double)c[0] + (double)c[2]) + ((double)c[1] + (double)c[3]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            if (lane == 0) part[(size_t)blockIdx.x * M + gr] = __double2float_rn(s);
        }
    }
}

// Left fold of the (chunks, M) chunk sums, ascending chunk order, from
// rows_start (a row-parallel linear's previous ranks) or 0.
__global__ void grad_da_rows_fold_kernel(const float* __restrict__ part,
                                         const float* __restrict__ rows_start,
                                         float* __restrict__ rows, int M, int nchunk) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= M) return;
    float acc = rows_start == nullptr ? 0.0f : rows_start[r];
    for (int c = 0; c < nchunk; ++c) acc += part[(size_t)c * M + r];
    rows[r] = acc;
}

// ---------------------------------------------------------------------------
// K3: dW = Aq^T . Gq over M.  X = Aq^T with Aq (M x K) rows along K, Y = Gq
// (M x N) rows along N.  Block (x: 128 columns of N, y: 128 rows of K).
// ---------------------------------------------------------------------------
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
grad_dw_kernel(const uint16_t* __restrict__ Aq, const uint16_t* __restrict__ Gq,
               const float* __restrict__ scal, float* __restrict__ dW, int M, int N, int K) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int k0 = blockIdx.y * BT, n0 = blockIdx.x * BT;
    block_product<false, false, VEC>(Operand{Aq, K, K, M}, Operand{Gq, N, N, M}, k0, n0, smem);
    const float* acc = reinterpret_cast<const float*>(
        reinterpret_cast<const double*>(smem) + 2 * tile_doubles(false));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float deq = scal[1];
    for (int rr = 0; rr < BT / 8; ++rr) {
        const int r = warp * (BT / 8) + rr, gk = k0 + r;
        if (gk >= K) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = lane + 32 * j, gn = n0 + col;
            if (gn < N) dW[(size_t)gk * N + gn] = acc[r * ACC_LD + col] * deq;
        }
    }
}

}  // namespace

// Gq (n,) bf16 = PoT(g * scalars[0]) with emax_g.
extern "C" int grad_g_quantize_launch(const float* g, const float* scalars, void* gq,
                                      long long n, int emax_g, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(gq);
    if (n > 0) {
        const bool vec4 =
            n % 4 == 0 && aligned16(g) && (reinterpret_cast<uintptr_t>(gq) & 7u) == 0;
        const long long work = vec4 ? n / 4 : n;
        const int blocks = (int)((work + 255) / 256 < 132 * 16 ? (work + 255) / 256 : 132 * 16);
        if (vec4)
            grad_g_quantize_kernel<true><<<blocks, 256, 0, st>>>(g, scalars, q, n, emax_g);
        else
            grad_g_quantize_kernel<false><<<blocks, 256, 0, st>>>(g, scalars, q, n, emax_g);
    }
    return static_cast<int>(cudaGetLastError());
}

// gq: (M, N) bf16 from grad_g_quantize_launch; w: (K, N) bf16.
// scalars: [2^-beta_g, 2^beta_g, clip_t] (clip_t read only with prc).
// start: null or the (M, K) f32 running sums to continue; raw: write the
// raw running sums (no dequant; prc must be 0).
// part: (ceil(K/128), M) f32 scratch, rows: (M,) f32, rows_start: null or
// (M,) f32 the rows' fold continues from; all unused without prc.
extern "C" int grad_da_launch(const void* gq, const void* w, const float* a,
                              const float* scalars, const float* start, float* da, float* part,
                              const float* rows_start, float* rows, int M, int N, int K, int prc,
                              int raw, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const uint16_t* x = static_cast<const uint16_t*>(gq);
    const uint16_t* y = static_cast<const uint16_t*>(w);
    if (M > 0 && K > 0) {
        const dim3 grid((K + BT - 1) / BT, (M + BT - 1) / BT);
        const bool vec = N % 8 == 0 && aligned16(gq) && aligned16(w);
        auto kernel = prc ? (vec ? grad_da_kernel<true, true> : grad_da_kernel<true, false>)
                          : (vec ? grad_da_kernel<false, true> : grad_da_kernel<false, false>);
        if (prc && raw) return static_cast<int>(cudaErrorInvalidValue);
        const cudaError_t e = launch_kernel(kernel, grid, THREADS, smem_bytes(true, true), st, x,
                                            y, a, scalars, start, da, part, M, N, K, raw);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (prc)
            grad_da_rows_fold_kernel<<<(M + 255) / 256, 256, 0, st>>>(part, rows_start, rows, M,
                                                                       grid.x);
    }
    return static_cast<int>(cudaGetLastError());
}

// aq: (M, K) bf16; gq: (M, N) bf16 from grad_g_quantize_launch.
// scalars: [2^-beta_g, 2^beta_g, ...]
extern "C" int grad_dw_launch(const void* aq, const void* gq, const float* scalars, float* dw,
                              int M, int N, int K, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const uint16_t* x = static_cast<const uint16_t*>(aq);
    const uint16_t* y = static_cast<const uint16_t*>(gq);
    if (K > 0 && N > 0) {
        const dim3 grid((N + BT - 1) / BT, (K + BT - 1) / BT);
        const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(aq) && aligned16(gq);
        const cudaError_t e = launch_kernel(vec ? grad_dw_kernel<true> : grad_dw_kernel<false>,
                                            grid, THREADS, smem_bytes(false, false), st, x, y,
                                            scalars, dw, M, N, K);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaGetLastError());
}
