// K4 on Hopper: the PoT encode, f32 -> one int8 code per element under one
// layer-wise scale 2^-beta.
//
// Replaces the Pallas TPU kernel repro/kernels/potq_encode.py
// `_encode_kernel` (launcher `potq_encode_padded`): the elementwise
// producer of the paper's int8 wire format (core/compress.py layout),
// which the port runs to pack trained weights (serve/quantized_weights.py
// `pack_int8`).
//
// Numeric spec (repro_torch/kernels/potq_encode.py `potq_encode_plain`):
//   r = round(log2|x * 2^-beta|) by the frexp rule: frexpf(|x|) = (m, e),
//       r = e - 1 + (m >= first f32 above sqrt(2)/2) - beta.  This is the
//       exponent of the scaled value without forming it, so it is exact
//       for every beta (also where 2^-beta is not a normal float) and for
//       subnormal x; where x * 2^-beta is exact it is that value's
//       rounding, and where it is not (a subnormal product) r < -126
//       flushes to 0 either way.
//   code = 0                    for +0, -0, NaN, and r < -emax;
//        = +-(2*emax + 1)       for +-inf (saturated);
//        = +-(min(r, emax) + emax + 1) otherwise, the sign of x.
//
// What bounds it on an H100: bytes.  It reads 4 B and writes 1 B per
// element and does a handful of integer operations on them, far below the
// card's ~295 operations a byte.  Design: a grid-stride loop in which each
// thread reads 16 B (float4) and writes its 4 codes as one 32-bit store,
// four such loads in flight per thread, with a scalar path for the last
// n % 4 elements and for pointers that are not 16/4-byte aligned.  beta
// is read from device memory, so it never travels to the host.  The
// TPU kernel's (256, 512) blocks are not carried over: the tensor is
// flat to this kernel.
//
// Plain C interface, loaded with ctypes.  Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ int encode_one(float x, int beta, int emax) {
    float mag = fabsf(x);
    if (isinf(x)) return x < 0.0f ? -(2 * emax + 1) : 2 * emax + 1;
    if (!(mag > 0.0f)) return 0;  // +0, -0 and NaN
    int e;
    float m = frexpf(mag, &e);
    int r = e - 1 + (m >= __int_as_float(0x3F3504F4) ? 1 : 0) - beta;
    if (r < -emax) return 0;
    int code = min(r, emax) + emax + 1;
    return x < 0.0f ? -code : code;
}

__device__ __forceinline__ uint32_t encode4(float4 v, int beta, int emax) {
    uint32_t c0 = static_cast<uint8_t>(encode_one(v.x, beta, emax));
    uint32_t c1 = static_cast<uint8_t>(encode_one(v.y, beta, emax));
    uint32_t c2 = static_cast<uint8_t>(encode_one(v.z, beta, emax));
    uint32_t c3 = static_cast<uint8_t>(encode_one(v.w, beta, emax));
    return c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);  // little-endian byte order
}

// Aligned path: nvec float4 loads -> nvec 32-bit stores, then the last
// n - 4 * nvec (< 4) elements by the first threads of block 0.
__global__ void encode_vec4_kernel(const float4* __restrict__ x,
                                   uint32_t* __restrict__ out, int64_t nvec,
                                   const float* __restrict__ tail_x,
                                   int8_t* __restrict__ tail_out, int tail,
                                   const int* __restrict__ beta_p, int emax) {
    const int beta = *beta_p;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    for (int64_t base = tid; base < nvec; base += UNROLL * stride) {
        float4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            int64_t i = base + u * stride;
            if (i < nvec) v[u] = __ldcs(x + i);  // streamed once: evict first
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            int64_t i = base + u * stride;
            if (i < nvec) __stcs(out + i, encode4(v[u], beta, emax));
        }
    }
    if (blockIdx.x == 0 && threadIdx.x < tail) {
        tail_out[threadIdx.x] =
            static_cast<int8_t>(encode_one(tail_x[threadIdx.x], beta, emax));
    }
}

// Unaligned views: one element per thread-iteration.
__global__ void encode_scalar_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ out, int64_t n,
                                     const int* __restrict__ beta_p, int emax) {
    const int beta = *beta_p;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        out[i] = static_cast<int8_t>(encode_one(x[i], beta, emax));
    }
}

int max_blocks() {
    static int blocks = 0;
    if (blocks == 0) {
        int dev = 0, sms = 132;
        if (cudaGetDevice(&dev) == cudaSuccess) {
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        }
        blocks = sms * 8;  // 8 resident blocks of 256 threads per SM
    }
    return blocks;
}

int grid_for(int64_t work) {
    int64_t blocks = (work + THREADS - 1) / THREADS;
    if (blocks > max_blocks()) blocks = max_blocks();
    return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" int potq_encode_launch(const float* x, int8_t* out, long long n,
                                  const int* beta, int emax, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (n > 0) {
        bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 4 == 0;
        if (aligned) {
            int64_t nvec = n / 4;
            int tail = static_cast<int>(n - 4 * nvec);
            encode_vec4_kernel<<<grid_for(nvec > 0 ? nvec : 1), THREADS, 0, st>>>(
                reinterpret_cast<const float4*>(x), reinterpret_cast<uint32_t*>(out),
                nvec, x + 4 * nvec, out + 4 * nvec, tail, beta, emax);
        } else {
            encode_scalar_kernel<<<grid_for(n), THREADS, 0, st>>>(x, out, n, beta, emax);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
