// K1 on Hopper: the MF-MAC forward, (M,K) @ (K,N) over PoT-valued operands,
// or E such products in one launch (the MoE experts: (E,M,K) @ (E,K,N)).
//
// Replaces the Pallas TPU kernel repro/kernels/potq_matmul.py
// `_potq_matmul_kernel` (launcher `potq_matmul_padded`), both modes:
//   quantize = 0: operands are already PoT values (bf16);
//   quantize = 1: raw f32 operands; an elementwise pre-pass PRC-clips A,
//                 WBC-shifts W, scales each by its exact power of two,
//                 rounds to the nearest PoT value and writes the scaled
//                 values as bf16 (exact: every value is 0 or +-2^e with
//                 |e| <= 15); the product below then runs on them and the
//                 epilogue multiplies by the dequant 2^(beta_a + beta_w).
//
// Numeric spec (repro_torch/kernels/ref.py, ACC_SCHEME
// "canonical-k128-exactchunk-leftfold-v1"): K is cut into canonical
// 128-wide chunks.  Each output's chunk sum is EXACT (its PoT products lie
// on one lattice of at most 2*emax_a + 2*emax_w + 8 <= 53 bits: one beta
// per row of A, one for all of W, so every fp64 partial sum is exact in
// any order), rounded ONCE to f32, and the chunk sums are left-folded in
// f32 in ascending chunk order from 0.0f; the fold is multiplied by `deq`.
// No atomics: the result is deterministic, row-independent and the same
// for every path below, which is what the serving engine's pool-vs-solo
// identity rests on.
//
// The expert batch.  potq_matmul_launch runs E independent products
// (expert e: A + e*M*K, W + e*K*N, out + e*M*N; one deq for all) in one
// launch, E = 1 for a single product: grid z holds E x the chunk ranges,
// expert-major, and each block is the block of a single-expert launch on
// its expert's operands.  The precondition holds per expert (each
// expert's W has its own beta, each row of A its own), so the batched
// result equals E single-expert launches bit for bit.
//
// Two paths and a split, chosen by the wrapper (kernels/potq_matmul.py `plan`) from
// M, N and K alone:
//
//  * tensor cores (M above the decode threshold: training, prefill).
//    potq_mm_tc runs block_product (fp64_mma.cuh, shared with K2/K3):
//    128 x 128 output tiles on the FP64 tensor cores (mma.sync m16n8k8
//    .f64).  What bounds it: 2*M*N*K operations, against 67 TFLOP/s.
//
//  * decode (M <= 32).  What bounds it: the weight bytes.  potq_mm_dec
//    makes every warp a task of its own: a strip of 256 columns (a lane
//    owns 8, read as 16 bytes per k-row) over a range of chunks, streamed
//    by cp.async (16-byte copies; scalar loads where rows are not 16-byte
//    aligned) through a 4-stage ring of 8 k-rows per warp that
//    needs no barrier; each W element is converted once (F2F) and feeds
//    the MR <= 8 rows of A (staged per chunk in the warp's shared memory
//    as fp64) by fp64 FMAs on the CUDA cores; a lane's fp64 sums are its
//    columns' exact chunk sums, rounded once -- no sum crosses lanes.
//
//  * the split.  Where a path's grid is too small to fill the 132 SMs (at
//    decode every llama3-8b shape but the LM head; at prefill, M = 128,
//    the shapes with N = 1024 and N = 4096), the chunk range is split
//    across blocks: each writes every chunk's rounded sums into a
//    (nchunk, M, N) f32 scratch, and potq_mm_fold left-folds them in
//    ascending chunk order from 0.0f and multiplies by deq -- the same
//    adds in the same order as one block walking all of K, so the same
//    bits.  Ranges are never summed before the fold.
//
// Plain C interface, loaded with ctypes.  Returns cudaGetLastError().

#include "fp64_mma.cuh"

namespace {

constexpr int DEC_COLS = 256;                     // decode strip: 32 lanes x 8 columns

__device__ __forceinline__ float dequant(const float* scal) {
    return scal == nullptr ? 1.0f : scal[2];
}

// ---------------------------------------------------------------------------
// Pre-pass of quantize = 1: q = PoT((clamp(x, +-clip) - shift) * scale) as
// bf16.  A: clip = scalars[4], shift 0, scale 2^-beta_a; W: no clip, shift
// = w_mean, scale 2^-beta_w.  (x - 0) is x and clamp(x, +-inf) is x, so
// each operand gets the plain version's exact operations.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
potq_mm_prequant(const float* __restrict__ x, const float* __restrict__ scal,
                 __nv_bfloat16* __restrict__ q, long long n, int is_w, int emax) {
    const float clip = is_w ? __int_as_float(0x7F800000) : scal[4];
    const float shift = is_w ? scal[3] : 0.0f;
    const float scale = is_w ? scal[1] : scal[0];
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const float v = fminf(fmaxf(x[i], -clip), clip);
        q[i] = __float2bfloat16_rn(quantize_pot((v - shift) * scale, emax));
    }
}

// ---------------------------------------------------------------------------
// Tensor-core path.  X = Aq (M x K, rows along K), Y = Wq (K x N, rows
// along N).  Block (x: 128 columns of N, y: 128 rows of M, z: expert x
// `ranges` chunk ranges of `span` columns of K with SPLIT).
// ---------------------------------------------------------------------------
template <bool VEC, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
potq_mm_tc(const uint16_t* __restrict__ Aq, const uint16_t* __restrict__ Wq,
           const float* __restrict__ scal, float* __restrict__ out, float* __restrict__ part,
           int M, int N, int K, int span, int ranges) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int m0 = blockIdx.y * BT, n0 = blockIdx.x * BT;
    const int ex = blockIdx.z / ranges;
    const size_t mn = (size_t)M * N;
    Aq += ex * (size_t)M * K;
    Wq += ex * (size_t)K * N;
    out += ex * mn;
    if constexpr (SPLIT) {
        // scratch (nchunk, E, M, N): a chunk's sums of every expert together
        const size_t cstride = mn * (gridDim.z / ranges);
        const int l0 = (blockIdx.z % ranges) * span;
        const int len = min(span, K - l0);
        block_product<true, false, VEC, true>(
            Operand{Aq + l0, K, M, len}, Operand{Wq + (size_t)l0 * N, N, N, len}, m0, n0, smem,
            part + ex * mn + (size_t)(l0 / CHUNK) * cstride, N, cstride);
    } else {
        block_product<true, false, VEC>(Operand{Aq, K, M, K}, Operand{Wq, N, N, K}, m0, n0, smem);
        const float* acc = reinterpret_cast<const float*>(
            reinterpret_cast<const double*>(smem) + tile_doubles(true) + tile_doubles(false));
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const float deq = dequant(scal);
        for (int rr = 0; rr < BT / 8; ++rr) {
            const int r = warp * (BT / 8) + rr, gm = m0 + r;
            if (gm >= M) break;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = lane + 32 * j, gn = n0 + col;
                if (gn < N) out[(size_t)gm * N + gn] = acc[r * ACC_LD + col] * deq;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Decode path.  Every warp is a task of its own: one strip of 256 columns
// (a lane owns 8) over a range of `span` chunks with SPLIT, else all of K,
// for MR rows of A.  A block is DEC_WPB warps on neighbouring strips of the
// same rows (grid x: strips / DEC_WPB, y: MR rows of M, z: expert x
// `ranges` chunk ranges).
// The warp streams its 128 k-rows a chunk in stages of 8 through a ring of
// DEC_STAGES in shared memory, lane l copying (cp.async) and reading only
// its own 16 bytes of each row, so the ring runs ahead across
// chunks with no barrier; each lane keeps the exact fp64 chunk sums of its
// 8 columns x MR rows, so no sum crosses lanes or warps.  The warp stages
// A's chunk (MR x 128, as fp64) in its own shared memory, fetched a chunk
// ahead into registers.
// ---------------------------------------------------------------------------
constexpr int DEC_WPB = 4;                               // warps a block
constexpr int DEC_STAGES = 4;                            // ring depth a warp
constexpr int DEC_STAGE_ROWS = 8;                        // k-rows of W in one stage
constexpr int DEC_STAGE_U4 = DEC_STAGE_ROWS * 32;        // 16-byte pieces of a stage
constexpr int DEC_CHUNK_STAGES = CHUNK / DEC_STAGE_ROWS;

__host__ __device__ constexpr size_t dec_warp_bytes(int mr) {
    return (size_t)DEC_STAGES * DEC_STAGE_U4 * 16 + 8 * (size_t)mr * CHUNK;
}
constexpr size_t dec_smem_bytes(int mr) { return DEC_WPB * dec_warp_bytes(mr); }

// 8 k-rows from k0 into `slot`: this lane's 16 bytes of each row (its 8
// columns), zero past K and N.  VEC: 16-byte cp.async (N % 8 == 0, W
// 16-byte aligned); else scalar loads, all 8 rows' issued before any is
// stored, so a stage waits out one memory latency, not one a row.
template <bool VEC>
__device__ __forceinline__ void dec_load(uint4* slot, const uint16_t* W, int N, int K, int k0,
                                         int col, int lane) {
    if (VEC) {
#pragma unroll
        for (int j = 0; j < DEC_STAGE_ROWS; ++j) {
            const int k = k0 + j;
            const bool ok = k < K && col < N;
            cp_async16(slot + j * 32 + lane, ok ? W + (size_t)k * N + col : W, ok);
        }
    } else {
        uint32_t v[DEC_STAGE_ROWS][8];
#pragma unroll
        for (int j = 0; j < DEC_STAGE_ROWS; ++j) {
            const int k = k0 + j;
            const uint16_t* src = W + (size_t)k * N + col;
#pragma unroll
            for (int e = 0; e < 8; ++e) v[j][e] = (k < K && col + e < N) ? __ldg(src + e) : 0u;
        }
#pragma unroll
        for (int j = 0; j < DEC_STAGE_ROWS; ++j)
            slot[j * 32 + lane] = make_uint4(v[j][0] | v[j][1] << 16, v[j][2] | v[j][3] << 16,
                                             v[j][4] | v[j][5] << 16, v[j][6] | v[j][7] << 16);
    }
}

template <int MR, bool VEC, bool SPLIT>
__global__ void __launch_bounds__(DEC_WPB * 32)
potq_mm_dec(const uint16_t* __restrict__ A, const uint16_t* __restrict__ W,
            const float* __restrict__ scal, float* __restrict__ out, float* __restrict__ part,
            int M, int N, int K, int span, int ranges) {
    constexpr int A_PER = MR * CHUNK / 32;  // A values a lane stages a chunk
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ex = blockIdx.z / ranges;
    const size_t mn = (size_t)M * N;
    const size_t cstride = mn * (gridDim.z / ranges);  // scratch (nchunk, E, M, N)
    A += ex * (size_t)M * K;
    W += ex * (size_t)K * N;
    out += ex * mn;
    const int col = (blockIdx.x * DEC_WPB + warp) * DEC_COLS + 8 * lane;
    if ((blockIdx.x * DEC_WPB + warp) * DEC_COLS >= N) return;  // a warp past the last strip
    unsigned char* mine = smem + warp * dec_warp_bytes(MR);
    uint4* ring = reinterpret_cast<uint4*>(mine);
    double* as = reinterpret_cast<double*>(mine + DEC_STAGES * DEC_STAGE_U4 * 16);
    const int m0 = blockIdx.y * MR;
    const int nchunk = (K + CHUNK - 1) / CHUNK;
    const int c_begin = SPLIT ? (blockIdx.z % ranges) * span : 0;
    const int c_end = SPLIT ? min(nchunk, c_begin + span) : nchunk;
    const int nstage = (c_end - c_begin) * DEC_CHUNK_STAGES;
    const int k_begin = c_begin * CHUNK;

    uint32_t a_next[A_PER];
    auto fetch_a = [&](int c) {
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int e = lane + 32 * i;
            const int row = m0 + e / CHUNK, k = c * CHUNK + e % CHUNK;
            a_next[i] = (row < M && k < K) ? A[(size_t)row * K + k] : 0u;
        }
    };
    auto store_a = [&]() {
#pragma unroll
        for (int i = 0; i < A_PER; ++i) as[lane + 32 * i] = bf16_to_f64(a_next[i]);
    };

#pragma unroll
    for (int q = 0; q < DEC_STAGES - 1; ++q) {
        if (q < nstage)
            dec_load<VEC>(ring + q * DEC_STAGE_U4, W, N, K, k_begin + q * DEC_STAGE_ROWS, col,
                          lane);
        cp_async_commit();
    }
    float acc[MR][8];
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
    if (c_begin < c_end) {
        fetch_a(c_begin);
        store_a();
    }
    __syncwarp();

    for (int c = c_begin; c < c_end; ++c) {
        if (c + 1 < c_end) fetch_a(c + 1);  // in flight while this chunk computes
        double p[MR][8];
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
            for (int e = 0; e < 8; ++e) p[r][e] = 0.0;
        for (int h = 0; h < DEC_CHUNK_STAGES; ++h) {
            const int q = (c - c_begin) * DEC_CHUNK_STAGES + h;
            cp_async_wait<DEC_STAGES - 2>();  // this lane's copies of stage q have landed
            {
                const int nq = q + DEC_STAGES - 1;  // refill the slot read one stage ago
                if (nq < nstage)
                    dec_load<VEC>(ring + (nq % DEC_STAGES) * DEC_STAGE_U4, W, N, K,
                                   k_begin + nq * DEC_STAGE_ROWS, col, lane);
                cp_async_commit();
            }
            const uint4* slot = ring + (q % DEC_STAGES) * DEC_STAGE_U4;
#pragma unroll
            for (int j = 0; j < DEC_STAGE_ROWS; ++j) {
                const uint4 v = slot[j * 32 + lane];
                const uint32_t w[4] = {v.x, v.y, v.z, v.w};
                const int kk = h * DEC_STAGE_ROWS + j;
                double a[MR];
#pragma unroll
                for (int r = 0; r < MR; ++r) a[r] = as[r * CHUNK + kk];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const double wd = bf16_to_f64(e & 1 ? w[e >> 1] >> 16 : w[e >> 1] & 0xffffu);
#pragma unroll
                    for (int r = 0; r < MR; ++r) p[r][e] = fma(a[r], wd, p[r][e]);
                }
            }
        }
        // the exact chunk sums, rounded once
#pragma unroll
        for (int r = 0; r < MR; ++r) {
            const int row = m0 + r;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float f = __double2float_rn(p[r][e]);
                if (SPLIT) {
                    if (row < M && col + e < N)
                        part[(size_t)c * cstride + ex * mn + (size_t)row * N + col + e] = f;
                } else {
                    acc[r][e] += f;
                }
            }
        }
        __syncwarp();  // every lane is done with this chunk's A
        if (c + 1 < c_end) store_a();
        __syncwarp();
    }
    cp_async_wait<0>();
    if (!SPLIT) {
        const float deq = dequant(scal);
#pragma unroll
        for (int r = 0; r < MR; ++r) {
            const int row = m0 + r;
#pragma unroll
            for (int e = 0; e < 8; ++e)
                if (row < M && col + e < N) out[(size_t)row * N + col + e] = acc[r][e] * deq;
        }
    }
}

// Left fold of the (nchunk, M*N) chunk sums in ascending chunk order, x deq.
__global__ void __launch_bounds__(256)
potq_mm_fold(const float* __restrict__ part, const float* __restrict__ scal,
             float* __restrict__ out, long long total, int nchunk) {
    const float deq = dequant(scal);
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        float acc = 0.0f;
        for (int c = 0; c < nchunk; ++c) acc += part[(size_t)c * total + i];
        out[i] = acc * deq;
    }
}

int grid_stride_blocks(long long n) {
    const long long b = (n + 255) / 256;
    return (int)(b < 132 * 16 ? (b > 0 ? b : 1) : 132 * 16);
}

template <int MR, bool VEC>
cudaError_t launch_dec(bool split, dim3 grid, cudaStream_t st, const uint16_t* a,
                       const uint16_t* w, const float* scal, float* out, float* part, int M,
                       int N, int K, int span, int ranges) {
    auto kernel = split ? potq_mm_dec<MR, VEC, true> : potq_mm_dec<MR, VEC, false>;
    return launch_kernel(kernel, grid, DEC_WPB * 32, dec_smem_bytes(MR), st, a, w, scal, out,
                         part, M, N, K, span, ranges);
}

template <int MR>
cudaError_t launch_dec_rows(bool vec, bool split, dim3 grid, cudaStream_t st, const uint16_t* a,
                            const uint16_t* w, const float* scal, float* out, float* part,
                            int M, int N, int K, int span, int ranges) {
    if (vec)
        return launch_dec<MR, true>(split, grid, st, a, w, scal, out, part, M, N, K, span, ranges);
    return launch_dec<MR, false>(split, grid, st, a, w, scal, out, part, M, N, K, span, ranges);
}

// E products (E = 1: one).  kind 0: decode, 1: tensor cores.  groups > 1
// splits the chunks into that many ranges (part: (ceil(K/128), E, M, N)
// f32), then folds.
cudaError_t product(const uint16_t* a, const uint16_t* w, const float* scal, float* out,
                    float* part, int E, int M, int N, int K, int kind, int groups,
                    cudaStream_t st) {
    const int nchunk = (K + CHUNK - 1) / CHUNK;
    const bool split = groups > 1 && nchunk > 1;
    const int per = split ? (nchunk + groups - 1) / groups : nchunk;  // chunks per range
    const int ranges = split ? (nchunk + per - 1) / per : 1;
    cudaError_t e;
    if (kind == 0) {
        const int mr = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
        const bool vec = N % 8 == 0 && aligned16(w);
        const int strips = (N + DEC_COLS - 1) / DEC_COLS;
        const dim3 grid((strips + DEC_WPB - 1) / DEC_WPB, (M + mr - 1) / mr, ranges * E);
        e = mr == 1   ? launch_dec_rows<1>(vec, split, grid, st, a, w, scal, out, part, M, N, K,
                                           per, ranges)
            : mr == 2 ? launch_dec_rows<2>(vec, split, grid, st, a, w, scal, out, part, M, N, K,
                                           per, ranges)
            : mr == 4 ? launch_dec_rows<4>(vec, split, grid, st, a, w, scal, out, part, M, N, K,
                                           per, ranges)
                      : launch_dec_rows<8>(vec, split, grid, st, a, w, scal, out, part, M, N, K,
                                           per, ranges);
    } else {
        const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(w);
        const dim3 grid((N + BT - 1) / BT, (M + BT - 1) / BT, ranges * E);
        auto kernel = split ? (vec ? potq_mm_tc<true, true> : potq_mm_tc<false, true>)
                            : (vec ? potq_mm_tc<true, false> : potq_mm_tc<false, false>);
        e = launch_kernel(kernel, grid, THREADS, smem_bytes(true, false), st, a, w, scal, out,
                          part, M, N, K, per * CHUNK, ranges);
    }
    if (e != cudaSuccess || !split) return e;
    const long long total = (long long)E * M * N;
    potq_mm_fold<<<grid_stride_blocks(total), 256, 0, st>>>(part, scal, out, total, nchunk);
    return cudaGetLastError();
}

}  // namespace

// quantize = 0, E products (E = 1: one).  a: (E, M, K) bf16 PoT values,
// w: (E, K, N) bf16 PoT values, out: (E, M, N) f32; scalars: null (deq 1)
// or the (5,) f32 [2^-beta_a, 2^-beta_w, deq, w_mean, clip_t], of which
// only deq is read; part: the (ceil(K/128), E, M, N) scratch when
// groups > 1.
extern "C" int potq_matmul_launch(const void* a, const void* w, const float* scalars,
                                  float* out, float* part, int E, int M, int N, int K, int kind,
                                  int groups, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (E > 0 && M > 0 && N > 0) {
        const cudaError_t e = product(static_cast<const uint16_t*>(a),
                                      static_cast<const uint16_t*>(w), scalars, out, part, E, M,
                                      N, K, kind, groups, st);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaGetLastError());
}

// quantize = 1.  a: (M, K) f32, w: (K, N) f32 raw operands; aq (M, K) and
// wq (K, N): bf16 buffers for the pre-pass; scalars as above, all read.
extern "C" int potq_matmul_quantize_launch(const float* a, const float* w,
                                           const float* scalars, void* aq, void* wq,
                                           float* out, float* part, int M, int N, int K,
                                           int emax_a, int emax_w, int kind, int groups,
                                           void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (M > 0 && N > 0) {
        __nv_bfloat16* qa = static_cast<__nv_bfloat16*>(aq);
        __nv_bfloat16* qw = static_cast<__nv_bfloat16*>(wq);
        const long long na = (long long)M * K, nw = (long long)K * N;
        if (na > 0)
            potq_mm_prequant<<<grid_stride_blocks(na), 256, 0, st>>>(a, scalars, qa, na, 0, emax_a);
        if (nw > 0)
            potq_mm_prequant<<<grid_stride_blocks(nw), 256, 0, st>>>(w, scalars, qw, nw, 1, emax_w);
        cudaError_t e = cudaGetLastError();
        if (e == cudaSuccess)
            e = product(reinterpret_cast<const uint16_t*>(qa), reinterpret_cast<const uint16_t*>(qw),
                        scalars, out, part, 1, M, N, K, kind, groups, st);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaGetLastError());
}
