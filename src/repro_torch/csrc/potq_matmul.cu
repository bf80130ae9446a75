// K1 on Hopper: the MF-MAC forward, (M,K) @ (K,N) over PoT-valued operands.
//
// Replaces the Pallas TPU kernel repro/kernels/potq_matmul.py
// `_potq_matmul_kernel` (launcher `potq_matmul_padded`), both modes:
//   quantize = 0: operands are already PoT values (bf16);
//   quantize = 1: raw f32 operands; each loaded element is PRC-clipped
//                 (A) or WBC-shifted (W), scaled by its exact power of two
//                 and rounded to the nearest PoT value in the tile.
//
// Numeric spec (repro_torch/kernels/ref.py): K is cut into canonical
// 128-wide chunks.  Each chunk's partial dot is computed EXACTLY (fp64
// FMAs: the PoT products of one chunk lie on one lattice of at most
// 2*emax_a + 2*emax_w + 8 <= 53 bits, so every fp64 partial sum is exact
// in any order), rounded ONCE to f32 (__double2float_rn), and the partials
// are left-folded into an f32 accumulator in ascending chunk order.  The
// epilogue multiplies by the scalar dequant.  No split-K across blocks and
// no atomics: the result is deterministic, row-independent and the same
// for every tiling, which is what the serving engine's pool-vs-solo
// identity rests on.
//
// What bounds it on an H100: the roofline (bf16 tensor cores, 3.35 TB/s)
// is bound by the weight bytes at both decode (M = 4) and prefill
// (M = 128) shapes.  Decode streams the whole weight once per call; at
// prefill this kernel is held instead by its own M*N*K fp64 FMAs on CUDA
// cores.  Design: the small-M kernel spreads the chunks of one 32-column
// strip over the warps of a block (partials are exact, so any warp may
// compute any chunk) and folds them in order through shared memory, so a
// strip streams W from 8 warps without split-K across blocks; the large-M
// kernel is a 64x64 register-tiled fp64 product over double-precision
// shared-memory tiles.  Wider strips for small N, tensor cores (wgmma),
// TMA and an integer shift-add datapath are left for a later change
// (PERF.md has the measured gap to the bound).
//
// Plain C interface, loaded with ctypes.  Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;  // canonical K chunk (CANONICAL_BK)

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

__device__ __forceinline__ float load_val(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
}

struct Scalars {
    float sa, sw, deq, wmean, clip;
};

__device__ __forceinline__ Scalars read_scalars(const float* s) {
    Scalars r;
    if (s == nullptr) {
        r.sa = 1.0f; r.sw = 1.0f; r.deq = 1.0f; r.wmean = 0.0f;
        r.clip = __int_as_float(0x7F800000);
    } else {
        r.sa = s[0]; r.sw = s[1]; r.deq = s[2]; r.wmean = s[3]; r.clip = s[4];
    }
    return r;
}

template <bool Q, typename T>
__device__ __forceinline__ float prep_a(const T* A, size_t i, const Scalars& s, int emax) {
    float v = load_val(A, i);
    if (Q) {
        v = fminf(fmaxf(v, -s.clip), s.clip);   // PRC
        v = quantize_pot(v * s.sa, emax);        // exact 2^-beta_a, then PoT
    }
    return v;
}

template <bool Q, typename T>
__device__ __forceinline__ float prep_w(const T* W, size_t i, const Scalars& s, int emax) {
    float v = load_val(W, i);
    if (Q) {
        v = v - s.wmean;                         // WBC
        v = quantize_pot(v * s.sw, emax);        // exact 2^-beta_w, then PoT
    }
    return v;
}

// ---------------------------------------------------------------------------
// Small M (decode): a block owns MR rows x 32 columns (one per lane).  Its
// NWARP warps take chunks c = round*NWARP + warp; each warp stages its A
// chunk (MR x 128, fp64) in shared memory and computes its exact partial;
// warp 0 then folds the round's partials in chunk order.
// ---------------------------------------------------------------------------
template <int MR, int NWARP, bool Q, typename T>
__global__ void __launch_bounds__(NWARP * 32)
potq_mm_small(const T* __restrict__ A, const T* __restrict__ W,
              const float* __restrict__ scal, float* __restrict__ out,
              int M, int N, int K, int emax_a, int emax_w) {
    __shared__ double As[NWARP][MR][CHUNK];
    __shared__ float part[NWARP][MR][32];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int col = blockIdx.x * 32 + lane;
    const int m0 = blockIdx.y * MR;
    const Scalars s = read_scalars(scal);
    const int nchunk = (K + CHUNK - 1) / CHUNK;
    float acc[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[r] = 0.0f;

    for (int base = 0; base < nchunk; base += NWARP) {
        const int c = base + warp;
        double p[MR];
#pragma unroll
        for (int r = 0; r < MR; ++r) p[r] = 0.0;
        if (c < nchunk) {
            const int k0 = c * CHUNK;
#pragma unroll
            for (int r = 0; r < MR; ++r) {
                const int row = m0 + r;
                for (int i = lane; i < CHUNK; i += 32) {
                    const int k = k0 + i;
                    float v = 0.0f;
                    if (row < M && k < K) v = prep_a<Q>(A, (size_t)row * K + k, s, emax_a);
                    As[warp][r][i] = (double)v;
                }
            }
            __syncwarp();
            const int kend = min(CHUNK, K - k0);
            if (col < N) {
#pragma unroll 4
                for (int i = 0; i < kend; ++i) {
                    const double wv = (double)prep_w<Q>(W, (size_t)(k0 + i) * N + col, s, emax_w);
#pragma unroll
                    for (int r = 0; r < MR; ++r) p[r] = fma(As[warp][r][i], wv, p[r]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < MR; ++r) part[warp][r][lane] = __double2float_rn(p[r]);
        __syncthreads();
        if (warp == 0) {
            for (int w = 0; w < NWARP && base + w < nchunk; ++w) {
#pragma unroll
                for (int r = 0; r < MR; ++r) acc[r] += part[w][r][lane];
            }
        }
        __syncthreads();
    }
    if (warp == 0 && col < N) {
#pragma unroll
        for (int r = 0; r < MR; ++r) {
            const int row = m0 + r;
            if (row < M) out[(size_t)row * N + col] = acc[r] * s.deq;
        }
    }
}

// ---------------------------------------------------------------------------
// Large M (prefill): 64x64 output tile per block, 256 threads, 4x4 outputs
// per thread.  K walks in order in sub-steps of 32 through fp64 shared
// tiles; every 128 columns (and at the K end) the exact partials are
// rounded once and added to the f32 accumulators.
// ---------------------------------------------------------------------------
constexpr int LBM = 64, LBN = 64, LKS = 32;

template <bool Q, typename T>
__global__ void __launch_bounds__(256)
potq_mm_large(const T* __restrict__ A, const T* __restrict__ W,
              const float* __restrict__ scal, float* __restrict__ out,
              int M, int N, int K, int emax_a, int emax_w) {
    __shared__ double As[LKS][LBM];
    __shared__ double Ws[LKS][LBN];
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int m0 = blockIdx.y * LBM, n0 = blockIdx.x * LBN;
    const Scalars s = read_scalars(scal);
    float acc[4][4];
    double p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) { acc[i][j] = 0.0f; p[i][j] = 0.0; }

    for (int k0 = 0; k0 < K; k0 += LKS) {
#pragma unroll
        for (int t = 0; t < (LBM * LKS) / 256; ++t) {
            const int idx = tid + t * 256;
            const int row = idx / LKS, kk = idx % LKS;
            const int gr = m0 + row, gk = k0 + kk;
            float v = 0.0f;
            if (gr < M && gk < K) v = prep_a<Q>(A, (size_t)gr * K + gk, s, emax_a);
            As[kk][row] = (double)v;
        }
#pragma unroll
        for (int t = 0; t < (LBN * LKS) / 256; ++t) {
            const int idx = tid + t * 256;
            const int kk = idx / LBN, cc = idx % LBN;
            const int gk = k0 + kk, gc = n0 + cc;
            float v = 0.0f;
            if (gk < K && gc < N) v = prep_w<Q>(W, (size_t)gk * N + gc, s, emax_w);
            Ws[kk][cc] = (double)v;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < LKS; ++kk) {
            double a[4], w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) p[i][j] = fma(a[i], w[j], p[i][j]);
        }
        __syncthreads();
        const int knext = k0 + LKS;
        if (knext % CHUNK == 0 || knext >= K) {
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
        const int gr = m0 + ty + 16 * i;
        if (gr >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gc = n0 + tx + 16 * j;
            if (gc < N) out[(size_t)gr * N + gc] = acc[i][j] * s.deq;
        }
    }
}

template <bool Q, typename T>
void launch(const T* A, const T* W, const float* scal, float* out, int M,
            int N, int K, int emax_a, int emax_w, cudaStream_t st) {
    const int nb = (N + 31) / 32;
    if (M <= 1) {
        potq_mm_small<1, 8, Q, T><<<dim3(nb, 1), 256, 0, st>>>(A, W, scal, out, M, N, K, emax_a, emax_w);
    } else if (M <= 2) {
        potq_mm_small<2, 8, Q, T><<<dim3(nb, 1), 256, 0, st>>>(A, W, scal, out, M, N, K, emax_a, emax_w);
    } else if (M <= 4) {
        potq_mm_small<4, 8, Q, T><<<dim3(nb, 1), 256, 0, st>>>(A, W, scal, out, M, N, K, emax_a, emax_w);
    } else if (M <= 32) {
        potq_mm_small<8, 4, Q, T><<<dim3(nb, (M + 7) / 8), 128, 0, st>>>(A, W, scal, out, M, N, K, emax_a, emax_w);
    } else {
        potq_mm_large<Q, T><<<dim3((N + LBN - 1) / LBN, (M + LBM - 1) / LBM), 256, 0, st>>>(
            A, W, scal, out, M, N, K, emax_a, emax_w);
    }
}

}  // namespace

extern "C" int potq_matmul_launch(const void* a, const void* w,
                                  const float* scalars, float* out, int M,
                                  int N, int K, int emax_a, int emax_w,
                                  int quantize, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (M > 0 && N > 0) {
        if (quantize) {
            launch<true, float>(static_cast<const float*>(a), static_cast<const float*>(w),
                                scalars, out, M, N, K, emax_a, emax_w, st);
        } else {
            launch<false, __nv_bfloat16>(static_cast<const __nv_bfloat16*>(a),
                                         static_cast<const __nv_bfloat16*>(w), scalars, out,
                                         M, N, K, emax_a, emax_w, st);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
