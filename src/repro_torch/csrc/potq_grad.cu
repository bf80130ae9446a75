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
// Design.  Block tile 128 x 128 outputs (K2: 128 rows of M x one 128-wide
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;           // canonical contraction chunk (CANONICAL_BK)
constexpr int BT = 128;              // block tile: BT x BT outputs
constexpr int THREADS = 256;         // 8 warps: 2 (rows) x 4 (columns)
constexpr int WM = 64, WN = 32;      // warp tile
constexpr int MMA_K = 8;             // m16n8k8 (k4 and k16 timed the same)
constexpr int STAGES = 3;            // bf16 ring depth (2 and 4 timed the same)
constexpr int BKS = 32;              // contraction slice per stage (16 is slower)
constexpr int KMAJ_LD = BKS + 4;     // fp64 tile [outer][k], row stride in doubles
constexpr int MN_LD = BT + 4;        // fp64 tile [k][outer]
constexpr int ACC_LD = BT + 8;       // f32 running sums [row][col]
constexpr int SEGS = BT * BKS / 8;   // 16-byte pieces of one operand slice
static_assert(CHUNK % BKS == 0 && BKS % MMA_K == 0 && SEGS % THREADS == 0, "tiling");
static_assert(STAGES >= 2, "a ring needs two stages");

__host__ __device__ constexpr int tile_doubles(bool kmaj) {
    return kmaj ? BT * KMAJ_LD : BKS * MN_LD;
}
constexpr size_t smem_bytes(bool xk, bool yk) {
    return 8 * (size_t)(tile_doubles(xk) + tile_doubles(yk)) + 4 * (size_t)BT * ACC_LD +
           2 * (size_t)STAGES * 2 * BT * BKS;
}

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

// bf16 bits -> double, exactly: bf16 -> f32 is a shift, F2F widens.  (F2F
// measured faster here than building the double's bits by integer ops.)
__device__ __forceinline__ double bf16_to_f64(uint32_t h) {
    return (double)__uint_as_float(h << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a . b on the FP64 tensor cores, m16n8k8; fragments as the PTX ISA
// lays them out: a[v] = A(g + 8*(v%2), t + 4*(v/2)), b[v] = B(t + 4v, g),
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}, g = lane/4, t = lane%4.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                       const double (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One operand of the product, bf16 in device memory.  KMAJ: element
// (outer o, contraction l) at p[o*ld + l] (rows along the contraction);
// otherwise at p[l*ld + o].  `outer` and `len` are the extents.
struct Operand {
    const uint16_t* p;
    int ld, outer, len;
};

// Piece s of a slice: its outer index o and contraction index l (the
// piece covers 8 consecutive elements along the operand's rows), and its
// offset in the bf16 stage, laid out like the operand's rows.
template <bool KMAJ>
__device__ __forceinline__ void piece(int s, int& o, int& l, int& off) {
    if (KMAJ) {
        o = s / (BKS / 8);
        l = (s % (BKS / 8)) * 8;
        off = o * BKS + l;
    } else {
        l = s / (BT / 8);
        o = (s % (BT / 8)) * 8;
        off = l * BT + o;
    }
}

// Start the copy of slice l0 of `op` (outer rows o0..o0+BT) into `stage`.
// VEC: rows are 16-byte aligned and every extent along them is a multiple
// of 8, so a piece is wholly inside or wholly outside (zero-filled).
// Otherwise masked scalar loads, stored synchronously.
template <bool KMAJ, bool VEC>
__device__ __forceinline__ void load_slice(uint16_t* stage, const Operand& op, int o0, int l0,
                                           int tid) {
#pragma unroll
    for (int r = 0; r < SEGS / THREADS; ++r) {
        int o, l, off;
        piece<KMAJ>(tid + r * THREADS, o, l, off);
        const int go = o0 + o, gl = l0 + l;
        if (VEC) {
            const bool ok = go < op.outer && gl < op.len;
            const uint16_t* src =
                ok ? op.p + (KMAJ ? (size_t)go * op.ld + gl : (size_t)gl * op.ld + go) : op.p;
            cp_async16(stage + off, src, ok);
        } else {
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
                uint32_t v[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int eo = KMAJ ? go : go + e + h, el = KMAJ ? gl + e + h : gl;
                    v[h] = (eo < op.outer && el < op.len)
                               ? op.p[KMAJ ? (size_t)eo * op.ld + el : (size_t)el * op.ld + eo]
                               : 0u;
                }
                w[e / 2] = v[0] | (v[1] << 16);
            }
            *reinterpret_cast<uint4*>(stage + off) = make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
}

// bf16 stage -> fp64 tile: KMAJ tile [o][l] (stride KMAJ_LD), else [l][o]
// (stride MN_LD); each piece is 8 consecutive doubles of one tile row.
template <bool KMAJ>
__device__ __forceinline__ void convert_slice(double* tile, const uint16_t* stage, int tid) {
#pragma unroll
    for (int r = 0; r < SEGS / THREADS; ++r) {
        int o, l, off;
        piece<KMAJ>(tid + r * THREADS, o, l, off);
        const uint4 raw = *reinterpret_cast<const uint4*>(stage + off);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        double* d = KMAJ ? tile + o * KMAJ_LD + l : tile + l * MN_LD + o;
        // the 4 double2 stores in a rotated order, so the 8 lanes of each
        // 128-byte store phase hit 8 different 16-byte bank groups
        const int rot = KMAJ ? (l >> 4) : ((o >> 4) & 3);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int c = (q + rot) & 3;
            *reinterpret_cast<double2*>(d + 2 * c) =
                make_double2(bf16_to_f64(w[c] & 0xffffu), bf16_to_f64(w[c] >> 16));
        }
    }
}

template <bool KMAJ>
__device__ __forceinline__ double tile_at(const double* tile, int o, int l) {
    return KMAJ ? tile[o * KMAJ_LD + l] : tile[l * MN_LD + o];
}

// The block's BT x BT tile of C = X . Y (X: I x L, Y: L x J), left in
// `acc` (f32, [row][col], stride ACC_LD) in the chunk scheme; ends with
// __syncthreads(), so any thread may read any element of `acc`.
template <bool XK, bool YK, bool VEC>
__device__ __forceinline__ void block_product(const Operand& X, const Operand& Y, int i0, int j0,
                                              unsigned char* smem) {
    double* xs = reinterpret_cast<double*>(smem);
    double* ys = xs + tile_doubles(XK);
    float* acc = reinterpret_cast<float*>(ys + tile_doubles(YK));
    uint16_t* ring = reinterpret_cast<uint16_t*>(acc + BT * ACC_LD);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wi = (warp >> 2) * WM, wj = (warp & 3) * WN;
    const int L = X.len;
    const int nslices = (L + BKS - 1) / BKS;

    double p[WM / 16][WN / 8][4];
#pragma unroll
    for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < WN / 8; ++nt) {
#pragma unroll
            for (int v = 0; v < 4; ++v) p[mt][nt][v] = 0.0;
            // each thread zeroes the sums it will own
            const int r = wi + mt * 16 + g, c = wj + nt * 8 + 2 * t;
            *reinterpret_cast<float2*>(acc + r * ACC_LD + c) = make_float2(0.0f, 0.0f);
            *reinterpret_cast<float2*>(acc + (r + 8) * ACC_LD + c) = make_float2(0.0f, 0.0f);
        }

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nslices) {
            uint16_t* stage = ring + st * 2 * BT * BKS;
            load_slice<XK, VEC>(stage, X, i0, st * BKS, tid);
            load_slice<YK, VEC>(stage + BT * BKS, Y, j0, st * BKS, tid);
        }
        cp_async_commit();
    }

    for (int s = 0; s < nslices; ++s) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // slice s landed; every warp is done with slice s-1's tiles
        {
            const int nx = s + STAGES - 1;
            if (nx < nslices) {
                uint16_t* stage = ring + (nx % STAGES) * 2 * BT * BKS;
                load_slice<XK, VEC>(stage, X, i0, nx * BKS, tid);
                load_slice<YK, VEC>(stage + BT * BKS, Y, j0, nx * BKS, tid);
            }
            cp_async_commit();
        }
        const uint16_t* stage = ring + (s % STAGES) * 2 * BT * BKS;
        convert_slice<XK>(xs, stage, tid);
        convert_slice<YK>(ys, stage + BT * BKS, tid);
        __syncthreads();

#pragma unroll
        for (int ks = 0; ks < BKS; ks += MMA_K) {
            double b[WN / 8][MMA_K / 4];
#pragma unroll
            for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
                for (int v = 0; v < MMA_K / 4; ++v)
                    b[nt][v] = tile_at<YK>(ys, wj + nt * 8 + g, ks + t + 4 * v);
#pragma unroll
            for (int mt = 0; mt < WM / 16; ++mt) {
                double a[MMA_K / 2];
#pragma unroll
                for (int v = 0; v < MMA_K / 2; ++v)
                    a[v] = tile_at<XK>(xs, wi + mt * 16 + g + 8 * (v & 1), ks + t + 4 * (v >> 1));
#pragma unroll
                for (int nt = 0; nt < WN / 8; ++nt) mma_f64(p[mt][nt], a, b[nt]);
            }
        }

        if ((s + 1) % (CHUNK / BKS) == 0 || s + 1 == nslices) {
            // chunk boundary: the exact partial, rounded once, into the f32 sums
#pragma unroll
            for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
                for (int nt = 0; nt < WN / 8; ++nt) {
                    const int r = wi + mt * 16 + g, c = wj + nt * 8 + 2 * t;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float2* q = reinterpret_cast<float2*>(acc + (r + 8 * h) * ACC_LD + c);
                        float2 v = *q;
                        v.x += __double2float_rn(p[mt][nt][2 * h]);
                        v.y += __double2float_rn(p[mt][nt][2 * h + 1]);
                        *q = v;
                        p[mt][nt][2 * h] = 0.0;
                        p[mt][nt][2 * h + 1] = 0.0;
                    }
                }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
}

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
template <bool PRC, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
grad_da_kernel(const uint16_t* __restrict__ Gq, const uint16_t* __restrict__ W,
               const float* __restrict__ A, const float* __restrict__ scal,
               float* __restrict__ dA, float* __restrict__ part, int M, int N, int K) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int m0 = blockIdx.y * BT, k0 = blockIdx.x * BT;
    block_product<true, true, VEC>(Operand{Gq, N, M, N}, Operand{W, N, K, N}, m0, k0, smem);
    const float* acc = reinterpret_cast<const float*>(
        reinterpret_cast<const double*>(smem) + 2 * tile_doubles(true));

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float deq = scal[1];
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
            float v = acc[r * ACC_LD + col] * deq;  // exact 2^beta_g dequant
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

// Left fold of the (chunks, M) chunk sums, ascending chunk order.
__global__ void grad_da_rows_fold_kernel(const float* __restrict__ part, float* __restrict__ rows,
                                         int M, int nchunk) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= M) return;
    float acc = 0.0f;
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

// Launch one of the product kernels: dynamic shared memory above 48 KB
// needs the attribute (set before every launch: a host-side call of about
// a microsecond, and per device).
template <typename... Params, typename... Args>
cudaError_t launch_product(void (*kernel)(Params...), dim3 grid, size_t smem, cudaStream_t st,
                           Args... args) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, THREADS, smem, st>>>(args...);
    return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

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
// part: (ceil(K/128), M) f32 scratch, rows: (M,) f32; both unused without prc.
extern "C" int grad_da_launch(const void* gq, const void* w, const float* a,
                              const float* scalars, float* da, float* part, float* rows,
                              int M, int N, int K, int prc, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const uint16_t* x = static_cast<const uint16_t*>(gq);
    const uint16_t* y = static_cast<const uint16_t*>(w);
    if (M > 0 && K > 0) {
        const dim3 grid((K + BT - 1) / BT, (M + BT - 1) / BT);
        const bool vec = N % 8 == 0 && aligned16(gq) && aligned16(w);
        auto kernel = prc ? (vec ? grad_da_kernel<true, true> : grad_da_kernel<true, false>)
                          : (vec ? grad_da_kernel<false, true> : grad_da_kernel<false, false>);
        const cudaError_t e = launch_product(kernel, grid, smem_bytes(true, true), st, x, y, a,
                                             scalars, da, part, M, N, K);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (prc) grad_da_rows_fold_kernel<<<(M + 255) / 256, 256, 0, st>>>(part, rows, M, grid.x);
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
        const cudaError_t e = launch_product(vec ? grad_dw_kernel<true> : grad_dw_kernel<false>,
                                             grid, smem_bytes(false, false), st, x, y, scalars,
                                             dw, M, N, K);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaGetLastError());
}
