// K2 and K3 on Hopper: the MF-MAC backward (paper Algorithm 1, lines 13-15).
//
//   K2  dA = Gq . Wq^T   (M,N) x (K,N)^T -> (M,K), PRC epilogue
//   K3  dW = Aq^T . Gq   (M,K)^T x (M,N) -> (K,N)
//
// Replace the Pallas TPU kernels repro/kernels/potq_grad.py
// `_grad_da_kernel` (launcher `grad_da_padded`) and `_grad_dw_kernel`
// (launcher `grad_dw_padded`).  Both read the raw f32 gradient G and
// quantize it on load: g * 2^-beta_g, rounded to the nearest PoT with
// emax_g (bits_g, or bits_g_last into the LM head); the output is
// dequantized once by 2^beta_g.  Wq is read in its (K,N) layout and Aq in
// its (M,K) layout: no transposed copies.
//
// Numeric spec (repro_torch/kernels/ref.py): the contraction axis (N for
// dA, M for dW) is cut into canonical 128-wide chunks; each chunk's
// partial is the EXACT sum of its PoT products (fp64 FMAs: one chunk lies
// on a lattice of 2*emax_x + 2*emax_y + 8 <= 53 bits, so every fp64
// partial sum is exact in any order), rounded once to f32
// (__double2float_rn), and the partials are left-folded in f32 in
// ascending chunk order.  K3's chunk runs over M, so it needs all of Aq on
// one activation scale (the wrapper refuses per-sample scales).
//
// PRC epilogue of K2: dA is zeroed where |a| > clip_t, and the dgamma
// rows sum where(clipped, dA_raw * sign(a), 0) over K.  Those are
// arbitrary f32 values, so the order is the spec's: inside a 128-wide K
// chunk a halves fold in fp64 (x[:64] + x[64:], then [:32] + [32:], ...),
// rounded once; then an f32 left fold over chunks.  A K2 block owns a
// 64 x 128 tile, one warp per 8 rows, a lane holding columns
// {l, l+32, l+64, l+96}: (c0 + c2) + (c1 + c3) is the first two halves
// steps and a __shfl_xor butterfly (16, 8, 4, 2, 1) the last five, which
// are the very same adds.  The chunk sums land in a (chunks, M) scratch,
// and a second small kernel folds them left per row, so no block carries
// a sum into another and there are no atomics.
//
// What bounds them on an H100: at the training shapes (M = 4096 tokens)
// the roofline (bf16 tensor cores, 3.35 TB/s) is bound by operations,
// 2*M*N*K at 989 TFLOP/s.  These kernels do M*N*K fp64 FMAs on CUDA cores
// instead, so they sit far above that bound; the design is K1's large-M
// one (register-tiled fp64 products over fp64 shared-memory tiles, exact
// chunk partial, one rounding per chunk, ordered f32 fold), which is
// right first.  A tensor-core or integer datapath is a later change
// (PERF.md has the measured gap).
//
// Plain C interface, loaded with ctypes.  Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;  // canonical contraction chunk (CANONICAL_BK)

__device__ __forceinline__ float sqrt_half_up() {
    return __int_as_float(0x3F3504F4);    // first f32 above sqrt(2)/2
}

// Round-to-nearest PoT of an already-scaled value: round(log2|x|) by the
// frexp rule, underflow below -emax to 0, saturate at emax.
__device__ __forceinline__ float quantize_pot(float x, int emax) {
    float mag = fabsf(x);
    if (mag == 0.0f) return 0.0f;
    int e;
    float m = frexpf(mag, &e);
    int r = e - 1 + (m >= sqrt_half_up() ? 1 : 0);
    if (r < -emax) return 0.0f;
    r = min(r, emax);
    return copysignf(__int_as_float((r + 127) << 23), x);
}

// ---------------------------------------------------------------------------
// K2: dA.  Block tile 64 rows (M) x 128 columns (K, one canonical chunk),
// 256 threads; warp ty owns rows ty + 8*i (i < 8), lane tx columns
// tx + 32*j (j < 4).  N walks in order in steps of 16 through fp64
// shared tiles; every 128 of N (and at the end) the exact partials are
// rounded once and added to the f32 accumulators.
// ---------------------------------------------------------------------------
constexpr int DA_BM = 64, DA_BK = CHUNK, DA_NS = 16;

template <bool PRC>
__global__ void __launch_bounds__(256)
grad_da_kernel(const float* __restrict__ G, const __nv_bfloat16* __restrict__ W,
               const float* __restrict__ A, const float* __restrict__ scal,
               float* __restrict__ dA, float* __restrict__ part,
               int M, int N, int K, int emax_g) {
    __shared__ double Gs[DA_NS][DA_BM + 1];
    __shared__ double Ws[DA_NS][DA_BK + 1];
    const int tid = threadIdx.x;
    const int tx = tid & 31, ty = tid >> 5;
    const int m0 = blockIdx.y * DA_BM, k0 = blockIdx.x * DA_BK;
    const float sg = scal[0], deq = scal[1];
    float acc[8][4];
    double p[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) { acc[i][j] = 0.0f; p[i][j] = 0.0; }

    for (int n0 = 0; n0 < N; n0 += DA_NS) {
#pragma unroll
        for (int t = 0; t < (DA_BM * DA_NS) / 256; ++t) {
            const int idx = tid + t * 256;
            const int row = idx / DA_NS, nn = idx % DA_NS;
            const int gr = m0 + row, gn = n0 + nn;
            float v = 0.0f;
            if (gr < M && gn < N) v = quantize_pot(G[(size_t)gr * N + gn] * sg, emax_g);
            Gs[nn][row] = (double)v;
        }
#pragma unroll
        for (int t = 0; t < (DA_BK * DA_NS) / 256; ++t) {
            const int idx = tid + t * 256;
            const int kr = idx / DA_NS, nn = idx % DA_NS;
            const int gk = k0 + kr, gn = n0 + nn;
            float v = 0.0f;
            if (gk < K && gn < N) v = __bfloat162float(W[(size_t)gk * N + gn]);
            Ws[nn][kr] = (double)v;
        }
        __syncthreads();
#pragma unroll 4
        for (int nn = 0; nn < DA_NS; ++nn) {
            double a[8], w[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = Gs[nn][ty + 8 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) w[j] = Ws[nn][tx + 32 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) p[i][j] = fma(a[i], w[j], p[i][j]);
        }
        __syncthreads();
        const int nnext = n0 + DA_NS;
        if (nnext % CHUNK == 0 || nnext >= N) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[i][j] += __double2float_rn(p[i][j]);
                    p[i][j] = 0.0;
                }
        }
    }

    float clip = 0.0f;
    if (PRC) clip = scal[2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int gr = m0 + ty + 8 * i;  // uniform across the warp
        float c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gc = k0 + tx + 32 * j;
            float v = acc[i][j] * deq;   // exact 2^beta_g dequant
            c[j] = 0.0f;
            if (gr < M && gc < K) {
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
            if (tx == 0 && gr < M) part[(size_t)blockIdx.x * M + gr] = __double2float_rn(s);
        }
    }
}

// Left fold of the (chunks, M) chunk sums, ascending chunk order.
__global__ void rows_fold_kernel(const float* __restrict__ part, float* __restrict__ rows,
                                 int M, int nchunk) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= M) return;
    float acc = 0.0f;
    for (int c = 0; c < nchunk; ++c) acc += part[(size_t)c * M + r];
    rows[r] = acc;
}

// ---------------------------------------------------------------------------
// K3: dW.  Block tile 64 rows (K) x 64 columns (N), 256 threads, 4x4
// outputs per thread; M walks in order in steps of 32 through fp64 shared
// tiles (both operands are read along their rows, coalesced); every 128
// of M (and at the end) the exact partials are rounded once and folded.
// ---------------------------------------------------------------------------
constexpr int DW_BK = 64, DW_BN = 64, DW_MS = 32;

__global__ void __launch_bounds__(256)
grad_dw_kernel(const __nv_bfloat16* __restrict__ Aq, const float* __restrict__ G,
               const float* __restrict__ scal, float* __restrict__ dW,
               int M, int N, int K, int emax_g) {
    __shared__ double As[DW_MS][DW_BK];
    __shared__ double Gs[DW_MS][DW_BN];
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int k0 = blockIdx.y * DW_BK, n0 = blockIdx.x * DW_BN;
    const float sg = scal[0], deq = scal[1];
    float acc[4][4];
    double p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) { acc[i][j] = 0.0f; p[i][j] = 0.0; }

    for (int m0 = 0; m0 < M; m0 += DW_MS) {
#pragma unroll
        for (int t = 0; t < (DW_MS * DW_BK) / 256; ++t) {
            const int idx = tid + t * 256;
            const int mm = idx / DW_BK, kc = idx % DW_BK;
            const int gm = m0 + mm, gk = k0 + kc;
            float v = 0.0f;
            if (gm < M && gk < K) v = __bfloat162float(Aq[(size_t)gm * K + gk]);
            As[mm][kc] = (double)v;
        }
#pragma unroll
        for (int t = 0; t < (DW_MS * DW_BN) / 256; ++t) {
            const int idx = tid + t * 256;
            const int mm = idx / DW_BN, nc = idx % DW_BN;
            const int gm = m0 + mm, gn = n0 + nc;
            float v = 0.0f;
            if (gm < M && gn < N) v = quantize_pot(G[(size_t)gm * N + gn] * sg, emax_g);
            Gs[mm][nc] = (double)v;
        }
        __syncthreads();
#pragma unroll 8
        for (int mm = 0; mm < DW_MS; ++mm) {
            double a[4], g[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[mm][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) g[j] = Gs[mm][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) p[i][j] = fma(a[i], g[j], p[i][j]);
        }
        __syncthreads();
        const int mnext = m0 + DW_MS;
        if (mnext % CHUNK == 0 || mnext >= M) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[i][j] += __double2float_rn(p[i][j]);
                    p[i][j] = 0.0;
                }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gk = k0 + ty + 16 * i;
        if (gk >= K) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gn = n0 + tx + 16 * j;
            if (gn < N) dW[(size_t)gk * N + gn] = acc[i][j] * deq;
        }
    }
}

}  // namespace

// scalars: [2^-beta_g, 2^beta_g, clip_t] (clip_t read only with prc).
// part: (ceil(K/128), M) f32 scratch, rows: (M,) f32; both unused without prc.
extern "C" int grad_da_launch(const float* g, const void* w, const float* a,
                              const float* scalars, float* da, float* part,
                              float* rows, int M, int N, int K, int emax_g,
                              int prc, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    if (M > 0 && K > 0) {
        const dim3 grid((K + DA_BK - 1) / DA_BK, (M + DA_BM - 1) / DA_BM);
        if (prc) {
            grad_da_kernel<true><<<grid, 256, 0, st>>>(g, wb, a, scalars, da, part,
                                                       M, N, K, emax_g);
            rows_fold_kernel<<<(M + 255) / 256, 256, 0, st>>>(part, rows, M, grid.x);
        } else {
            grad_da_kernel<false><<<grid, 256, 0, st>>>(g, wb, a, scalars, da, part,
                                                        M, N, K, emax_g);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// scalars: [2^-beta_g, 2^beta_g, ...]
extern "C" int grad_dw_launch(const void* aq, const float* g, const float* scalars,
                              float* dw, int M, int N, int K, int emax_g,
                              void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (K > 0 && N > 0) {
        const dim3 grid((N + DW_BN - 1) / DW_BN, (K + DW_BK - 1) / DW_BK);
        grad_dw_kernel<<<grid, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(aq), g,
                                             scalars, dw, M, N, K, emax_g);
    }
    return static_cast<int>(cudaGetLastError());
}
