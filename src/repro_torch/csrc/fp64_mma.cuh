// The FP64 tensor-core product shared by K1 (csrc/potq_matmul.cu) and K2/K3
// (csrc/potq_grad.cu): one block computes a 128 x 128 tile of C = X . Y over
// PoT-valued bf16 operands in the port's chunk scheme.
//
// Why the tensor cores keep the bits: one output's products of one 128-wide
// chunk lie on a lattice of at most 2*emax_x + 2*emax_y + 8 <= 53 bits
// (ref.check_exact_spread), so every partial sum of them is a representable
// double and `mma.sync ... .f64`, which does IEEE fp64 multiply-adds, gives
// the exact chunk sum in whatever order it adds a k-step.  Each exact sum
// is rounded once to f32 and added to the f32 running sum of its output,
// in ascending chunk order (or, with SPLIT, written out per chunk for a
// fold kernel to add in that order).
//
// Design (measured on K2/K3, PERF.md): block tile 128 x 128, 256 threads =
// 8 warps in 2 x 4, warp tile 64 x 32 = 4 x 4 MMAs of m16n8k8, 64 fp64
// accumulators a thread; the contraction walks in slices of 32 through a
// ring of 3 bf16 stages in dynamic shared memory, filled by 16-byte
// cp.async (zero-filled past the ragged edge; masked scalar loads where
// rows are not 16-byte aligned); each slice is converted once per block
// (F2F) into padded fp64 tiles whose fragment loads and stores are free of
// bank conflicts; the f32 running sums (128 x 136) live in shared memory.
//
// Included by one translation unit each: everything is in an anonymous
// namespace.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

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
// SPLIT: each chunk's rounded sums go instead to part[chunk][row][col]
// (chunk counted from the operands' start, row stride ldp, chunk stride
// cstride; rows i0.. below X.outer, columns j0.. below Y.outer), for a fold
// kernel to add in ascending chunk order; `acc` is then left at zero.
// `start` (without SPLIT; null: 0.0f): the f32 running sums begin at
// start[row][col] (row stride lds) instead of 0 -- a fold continued from
// another rank's running sum (K2's chain over a split contraction).
template <bool XK, bool YK, bool VEC, bool SPLIT = false>
__device__ __forceinline__ void block_product(const Operand& X, const Operand& Y, int i0, int j0,
                                              unsigned char* smem, float* part = nullptr,
                                              int ldp = 0, size_t cstride = 0,
                                              const float* start = nullptr, int lds = 0) {
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
            // each thread sets the sums it will own: 0, or start's values
            const int r = wi + mt * 16 + g, c = wj + nt * 8 + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float2 v = make_float2(0.0f, 0.0f);
                const int gr = i0 + r + 8 * h, gc = j0 + c;
                if (start != nullptr && gr < X.outer) {
                    if (gc < Y.outer) v.x = start[(size_t)gr * lds + gc];
                    if (gc + 1 < Y.outer) v.y = start[(size_t)gr * lds + gc + 1];
                }
                *reinterpret_cast<float2*>(acc + (r + 8 * h) * ACC_LD + c) = v;
            }
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
            if constexpr (SPLIT) {
                float* pc = part + (size_t)(s / (CHUNK / BKS)) * cstride;
#pragma unroll
                for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
                    for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
                        for (int v = 0; v < 4; ++v) {
                            const int r = i0 + wi + mt * 16 + g + 8 * (v >> 1);
                            const int c = j0 + wj + nt * 8 + 2 * t + (v & 1);
                            if (r < X.outer && c < Y.outer)
                                pc[(size_t)r * ldp + c] = __double2float_rn(p[mt][nt][v]);
                            p[mt][nt][v] = 0.0;
                        }
                continue;
            }
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

// Dynamic shared memory above 48 KB needs the attribute, once per device
// and kernel (a host-side call of about a microsecond, so not per launch).
cudaError_t allow_smem(const void* kernel, size_t smem) {
    struct Seen {
        const void* kernel;
        int device;
        size_t smem;
    };
    static std::mutex mu;
    static Seen seen[64];
    static int nseen = 0;
    int device;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < nseen; ++i)
        if (seen[i].kernel == kernel && seen[i].device == device && seen[i].smem >= smem)
            return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && nseen < 64) seen[nseen++] = Seen{kernel, device, smem};
    return e;
}

// Launch a kernel with `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_kernel(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                          cudaStream_t st, Args... args) {
    const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, threads, smem, st>>>(args...);
    return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace
