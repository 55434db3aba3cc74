// Tensor-core GEMM for bfloat16 operands with the epilogue of xfm_gemm
// (vss_stage.cu): the dense products of the bfloat16 backbone's VSSBlock
// sequence, in the stage kernel (kernel 1, xfmamba_tpu/ops/
// vss_block_pallas_v2.py::_vss_stage_kernel_v2, :542), its training forms
// (kernels 4 and 5, :412 and :658), the block adjoint (kernel 6,
// xfmamba_tpu/ops/vss_block_v2_adjoint.py::_vss_block_bwd_kernel, :128) and
// the v1 block (kernel 8, xfmamba_tpu/ops/vss_block_pallas.py::
// _vss_block_kernel, :295).  The TPU kernels run these products on the MXU
// inside their bodies.
//
//   out(m, n) = epilogue(sum_k A(m, k) B(n, k)),  A(m, k) at a[m sam + k sak],
//   B(n, k) at b[n sbn + k sbk], out(m, n) at out[m ldm + n ldn]
// Each operand is K-major (its k stride is 1: an activation against an
// nn.Linear weight) or MN-major (its row stride is 1: the transposed
// operands of dX = dY W and dW = dY^T X).  Sums in float32; the epilogue,
// in float32 and in this order: + bias[n], exact-erf GELU,
// * scale[m / scale_rows], + res(m, n) (float32 or bfloat16, the output's
// strides, may alias out); output float32 or bfloat16.  With splits > 1
// the K axis is cut into `splits` slices (grid.z) whose sums are added
// into a zeroed float32 out with atomics, and no epilogue applies: the
// weight gradients, whose K is the B * H * W rows.
//
// Design: warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate) on tiles
// of BM x BN x 32 in shared memory, fed by a three-stage cp.async ring
// (16-byte copies, zero-filled past the edges) and read with ldmatrix,
// .trans for the MN-major operands, so one kernel serves the four layout
// pairs without a transposed copy.  Rows are padded by 8 elements, so the
// eight rows of an ldmatrix fall in different banks.  An operand whose
// base or row stride is not 16-byte aligned (a rank slice of the
// projection rows, R = 6 at 12-byte offsets) is loaded element by element
// into the same tiles.  The host picks BN (16, 32, 64 or 128) from N, so
// the rank gradients (N = R) waste no 128-wide tile, and puts the short
// side of a weight gradient on N (it computes out^T) where that shortens
// the tile.  8 warps per block, at most 128 registers a thread so that two
// blocks share an SM; each warp holds a (BM / WM) x (BN / WN) piece of the
// accumulator in registers.  The epilogue stages the sums in
// shared memory and moves bias, residual and output as 16-byte vectors.
//
// What bounds it on the H100: the block's products are thin (K or N at
// most 4d = 3,072, mostly 96-1,536), so their arithmetic intensity sits
// below the card's 295 operations per byte and device-memory bandwidth
// bounds them; mma.sync reaches well past that rate here, so wgmma and TMA
// would move the bound nowhere for these shapes.  Split-K fills the card
// for the weight gradients, whose output tiles are few.
#include "common.cuh"
#include "mma.cuh"

namespace xfm {

constexpr int kTcBM = 128;
constexpr int kTcBK = 32;
constexpr int kTcStages = 3;
constexpr int kTcThreads = 256;
constexpr int kTcPad = 8;

struct TcParams {
  const uint16_t* a;
  const uint16_t* b;
  const float* bias;
  const float* scale;
  const void* res;
  void* out;
  long long M, sam, sak, sbn, sbk, ldm, ldn;
  int N, K, scale_rows, gelu, splits, out_f32, res_f32;
  int a_kmajor, b_kmajor, a_vec, b_vec;
};

// Elements of one operand tile in shared memory: rows x (BK + pad) when
// K-major, BK x (rows + pad) when MN-major; the larger of the two.
__host__ __device__ constexpr int tc_tile_elems(int rows) {
  return rows * (kTcBK + kTcPad) > kTcBK * (rows + kTcPad) ? rows * (kTcBK + kTcPad)
                                                           : kTcBK * (rows + kTcPad);
}

// Load the tile of one operand with `rows` rows (M or N) starting at r0
// and the k range [k0, k0 + BK) clipped to [.., kend), zero past the
// edges.  s_row / s_k are the operand's element strides.
template <int ROWS>
__device__ __forceinline__ void tc_load_tile(uint16_t* tile, const uint16_t* base, long long r0,
                                             long long rtot, int k0, int kend, long long s_row,
                                             long long s_k, bool kmajor, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    if (kmajor) {  // 8 consecutive k of one row per copy
      constexpr int kChunks = ROWS * (kTcBK / 8);
      for (int c = tid; c < kChunks; c += kTcThreads) {
        const int row = c / (kTcBK / 8), kc = (c % (kTcBK / 8)) * 8;
        const long long r = r0 + row;
        const int k = k0 + kc;
        const int valid = r < rtot ? max(0, min(8, kend - k)) : 0;
        const uint16_t* src = valid > 0 ? base + r * s_row + k : base;
        cp_async16(tile + row * (kTcBK + kTcPad) + kc, src, 2 * valid);
      }
    } else {  // 8 consecutive rows of one k per copy
      constexpr int kPerK = ROWS / 8;
      for (int c = tid; c < kTcBK * kPerK; c += kTcThreads) {
        const int kk = c / kPerK, rc = (c % kPerK) * 8;
        const long long r = r0 + rc;
        const int k = k0 + kk;
        const int valid = k < kend ? static_cast<int>(max(0LL, min(8LL, rtot - r))) : 0;
        const uint16_t* src = valid > 0 ? base + static_cast<long long>(k) * s_k + r : base;
        cp_async16(tile + kk * (ROWS + kTcPad) + rc, src, 2 * valid);
      }
    }
    return;
  }
  // element by element, neighbouring threads along the contiguous axis
  for (int e = tid; e < ROWS * kTcBK; e += kTcThreads) {
    const int row = kmajor ? e / kTcBK : e % ROWS;
    const int kk = kmajor ? e % kTcBK : e / ROWS;
    const long long r = r0 + row;
    const int k = k0 + kk;
    const uint16_t v = (r < rtot && k < kend) ? base[r * s_row + static_cast<long long>(k) * s_k]
                                              : static_cast<uint16_t>(0);
    tile[kmajor ? row * (kTcBK + kTcPad) + kk : kk * (ROWS + kTcPad) + row] = v;
  }
}

template <int BN, int WM, int WN>
__global__ void __launch_bounds__(kTcThreads, 2) gemm_tc_kernel(TcParams p) {
  constexpr int BM = kTcBM;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's piece
  constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(WM * WN * 32 == kTcThreads, "8 warps");
  static_assert(MI >= 1 && NI >= 2 && NI % 2 == 0, "warp tile");
  constexpr int A_ELEMS = tc_tile_elems(BM), B_ELEMS = tc_tile_elems(BN);
  extern __shared__ __align__(16) uint16_t tc_smem[];
  uint16_t* As = tc_smem;
  uint16_t* Bs = tc_smem + kTcStages * A_ELEMS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int kslice = ((p.K + p.splits - 1) / p.splits + kTcBK - 1) / kTcBK * kTcBK;
  const int kbeg = blockIdx.z * kslice;
  const int kend = min(p.K, kbeg + kslice);
  const int nk = kend > kbeg ? (kend - kbeg + kTcBK - 1) / kTcBK : 0;
  const bool akm = p.a_kmajor, bkm = p.b_kmajor;
  // the strides along the tile rows and along k
  const long long a_row = p.sam, a_k = p.sak, b_row = p.sbn, b_k = p.sbk;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int stage, int kt) {
    const int k0 = kbeg + kt * kTcBK;
    tc_load_tile<BM>(As + stage * A_ELEMS, p.a, m0, p.M, k0, kend, a_row, a_k, akm, p.a_vec);
    tc_load_tile<BN>(Bs + stage * B_ELEMS, p.b, n0, p.N, k0, kend, b_row, b_k, bkm, p.b_vec);
  };

#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    const int nxt = kt + kTcStages - 1;
    if (nxt < nk) load(nxt % kTcStages, nxt);
    cp_async_commit();
    const uint16_t* At = As + (kt % kTcStages) * A_ELEMS;
    const uint16_t* Bt = Bs + (kt % kTcStages) * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int mb = wm * WTM + i * 16;
        const int jm = lane >> 3, rr = lane & 7;
        const uint16_t* ptr =
            akm ? At + (mb + (lane & 15)) * (kTcBK + kTcPad) + kk + (lane >> 4) * 8
                : At + (kk + (jm >> 1) * 8 + rr) * (BM + kTcPad) + mb + (jm & 1) * 8;
        ldmatrix_x4(af[i], ptr, !akm);
      }
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        const int nb = wn * WTN + j * 8;
        const int jm = lane >> 3, rr = lane & 7;
        const uint16_t* ptr =
            bkm ? Bt + (nb + (jm >> 1) * 8 + rr) * (kTcBK + kTcPad) + kk + (jm & 1) * 8
                : Bt + (kk + (jm & 1) * 8 + rr) * (BN + kTcPad) + nb + (jm >> 1) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, ptr, !bkm);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the tiles: the sums are staged there

  // The epilogue, half the block's rows at a time: each warp writes its
  // sums to a float32 tile in shared memory, then each thread takes 8
  // consecutive columns of a row, so bias, residual and output move as
  // 16-byte vectors where the strides allow.
  constexpr int HALF = BM / 2, CLD = BN + 8;
  static_assert(HALF * CLD * 4 <= kTcStages * (A_ELEMS + B_ELEMS) * 2, "epilogue tile");
  float* Cs = reinterpret_cast<float*>(tc_smem);
  const int g = lane >> 2, t4 = lane & 3;
  const int osize = p.out_f32 ? 4 : 2, rsize = p.res_f32 ? 4 : 2;
  // 8 columns are one aligned vector when columns are contiguous and every
  // row starts on a 16-byte boundary
  const bool vec_out = p.ldn == 1 && (p.ldm * osize) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  const bool vec_res = p.res && p.ldn == 1 && (p.ldm * rsize) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.res) % 16 == 0;
  for (int half = 0; half < 2; ++half) {
    if (wm * WTM / HALF == half) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int r = wm * WTM - half * HALF + i * 16 + g, c = wn * WTN + j * 8 + 2 * t4;
          *reinterpret_cast<float2*>(Cs + r * CLD + c) = make_float2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<float2*>(Cs + (r + 8) * CLD + c) =
              make_float2(acc[i][j][2], acc[i][j][3]);
        }
    }
    __syncthreads();
    for (int it = threadIdx.x; it < HALF * (BN / 8); it += kTcThreads) {
      const int r = it / (BN / 8), c = (it % (BN / 8)) * 8;
      const long long m = m0 + half * HALF + r;
      const int n = n0 + c;
      if (m >= p.M || n >= p.N) continue;
      const int cnt = min(8, p.N - n);
      float v[8];
      const float4 lo = *reinterpret_cast<const float4*>(Cs + r * CLD + c);
      const float4 hi = *reinterpret_cast<const float4*>(Cs + r * CLD + c + 4);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      const long long o = m * p.ldm + static_cast<long long>(n) * p.ldn;
      if (p.splits > 1) {
        for (int e = 0; e < cnt; ++e) atomicAdd(static_cast<float*>(p.out) + o + e * p.ldn, v[e]);
        continue;
      }
      if (p.bias)
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += e < cnt ? p.bias[n + e] : 0.f;
      if (p.gelu)
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = gelu_erf(v[e]);
      if (p.scale) {
        const float sc = p.scale[m / p.scale_rows];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= sc;
      }
      const bool full = cnt == 8;
      if (p.res) {
        if (vec_res && full) {
          if (p.res_f32) {
            const float4* rp = reinterpret_cast<const float4*>(static_cast<const float*>(p.res) + o);
            const float4 a = rp[0], b = rp[1];
            v[0] += a.x, v[1] += a.y, v[2] += a.z, v[3] += a.w;
            v[4] += b.x, v[5] += b.y, v[6] += b.z, v[7] += b.w;
          } else {
            const uint4 q = *reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(p.res) + o);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(h[e]);
              v[2 * e] += f.x;
              v[2 * e + 1] += f.y;
            }
          }
        } else {
          for (int e = 0; e < cnt; ++e)
            v[e] += p.res_f32 ? static_cast<const float*>(p.res)[o + e * p.ldn]
                              : to_f32(static_cast<const __nv_bfloat16*>(p.res)[o + e * p.ldn]);
        }
      }
      if (vec_out && full) {
        if (p.out_f32) {
          float4* op = reinterpret_cast<float4*>(static_cast<float*>(p.out) + o);
          op[0] = make_float4(v[0], v[1], v[2], v[3]);
          op[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          uint4 q;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
          for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + o) = q;
        }
      } else {
        for (int e = 0; e < cnt; ++e) {
          if (p.out_f32) {
            static_cast<float*>(p.out)[o + e * p.ldn] = v[e];
          } else {
            static_cast<__nv_bfloat16*>(p.out)[o + e * p.ldn] = __float2bfloat16(v[e]);
          }
        }
      }
    }
    __syncthreads();  // the next half overwrites the tile
  }
}

template <int BN, int WM, int WN>
cudaError_t launch_tc(const TcParams& p, cudaStream_t s) {
  constexpr int smem = kTcStages * (tc_tile_elems(kTcBM) + tc_tile_elems(BN)) * 2;
  static bool ready = false;  // the attribute is set once, outside any stream capture
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tc_kernel<BN, WM, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(ceil_div(p.N, BN), ceil_div(p.M, kTcBM), p.splits);
  gemm_tc_kernel<BN, WM, WN><<<grid, kTcThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace xfm

using namespace xfm;

extern "C" int xfm_gemm_tc(const void* a, const void* b, const float* bias, const float* scale,
                           const void* res, void* out, long long M, int N, int K, long long sam,
                           long long sak, long long sbn, long long sbk, long long ldm,
                           long long ldn, int scale_rows, int gelu, int splits, int out_dtype,
                           int res_dtype, int a_kmajor, int b_kmajor, int a_vec, int b_vec,
                           int bn, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || ceil_div(M, kTcBM) > 65535 ||
      (splits > 1 && (out_dtype != kF32 || bias || scale || res || gelu)) ||
      (scale && scale_rows < 1) || (res && res_dtype != kF32 && res_dtype != kBF16) ||
      (out_dtype != kF32 && out_dtype != kBF16))
    return cudaErrorInvalidValue;
  TcParams p{static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b), bias, scale, res,
             out, M, sam, sak, sbn, sbk, ldm, ldn, N, K, scale_rows, gelu, splits,
             out_dtype == kF32, res_dtype == kF32, a_kmajor, b_kmajor, a_vec, b_vec};
  auto s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 128: return launch_tc<128, 2, 4>(p, s);
    case 64: return launch_tc<64, 4, 2>(p, s);
    case 32: return launch_tc<32, 4, 2>(p, s);
    case 16: return launch_tc<16, 8, 1>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
