// The two-level scan of one (channel tile, image, kind) item, as a device
// function: the body of scan_two_level.cu's kernel (kernels 8's old
// sequence, 9 and 10) and the scan phase of vss_block_v1.cu's cooperative
// block kernel (kernel 8).  See scan_two_level.cu for the recurrence and
// the design: each of the item's chunks (`segs` image rows or columns of
// the kind's traversal, one per thread row j) is reduced to its pair
// (prod a, h from 0), the pairs are chained in traversal order, and each
// chunk is walked again from its carry to write the kind's part.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace xfm {

constexpr int kTLMaxChunks = 16;
constexpr int kTLMaxR = 64;

struct TwoLevelParams {
  const void* u;      // (n_img, L, D)
  const void* dts;    // deltas: row stride dt_stride, kind stride D
  const void* ranks;  // rank form: row stride rank_stride, kind stride R
  const float* w_dt;  // (K, R, D)
  const void* Bp;     // B[l, k, n] at row * bc_stride + k * bc_k_stride + n * bc_n_stride
  const void* Cp;     // C, same strides as B
  const float* A;     // (K, N, D)
  const float* bias;  // (K, D)
  const float* Dk;    // (K, D) skip added to each part (kernel 10), or null
  float* part;        // (K, n_img, L, D)
  int n_img, H, W, D, K, N, R, kinds, segs;
  int dt_stride, rank_stride, bc_stride, bc_k_stride, bc_n_stride;
  int round_rank;  // rank values rounded to bfloat16 (the TPU kernel's xdbl cast)
  int round_part;  // parts rounded to bfloat16 (kernel 10's N = 1 output dtype)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Shared floats an item of CH channels needs.
template <int CH>
__host__ __device__ constexpr int two_level_smem_floats() {
  return kTLMaxR * CH + 3 * kTLMaxChunks * CH;
}

// Shared floats STAGED adds: deltas and u [L][CH], B and C [L][2], the
// rank values [L][R].
__host__ __device__ constexpr int two_level_staged_floats(int L, int CH, int R) {
  return L * (2 * CH + 2 + R);
}

// One item: channels ctile * CH.., image img, kind k.  Thread (tx, j) of
// the block holds channel tx and chunk j (j < kTLMaxChunks); nthreads is
// the block's size; every thread of the block calls it (it synchronises).
// smem holds two_level_smem_floats<CH>() floats, and with STAGED (rank
// form, one state; the block's threads are (j, tx) = threadIdx.x / CH,
// threadIdx.x % CH) two_level_staged_floats(L, CH, R) more: the block
// first stages the item's inputs (u, B, C, the rank values) and computes
// its deltas at every position, all its threads at once (the rank
// projection on the tensor cores), and the walks read shared memory only
// instead of summing R products at each step.
template <typename T, int MAXN, bool RANK, int CH, bool STAGED = false>
__device__ __forceinline__ void two_level_scan_item(const TwoLevelParams& p, int ctile, int img,
                                                    int k, int tx, int j, int nthreads,
                                                    float* smem) {
  static_assert(!STAGED || (RANK && MAXN == 1), "staged: the rank form, one state");
  float* wdt_s = smem;                       // [kTLMaxR][CH]
  float* prod_s = smem + kTLMaxR * CH;       // [kTLMaxChunks][CH]
  float* loc_s = prod_s + kTLMaxChunks * CH;
  float* cin_s = loc_s + kTLMaxChunks * CH;
  float* dl_s = cin_s + kTLMaxChunks * CH;   // STAGED: the deltas [L][CH]
  const int c0 = ctile * CH;
  const int c = c0 + tx;
  const bool active = c < p.D;
  const int cc = active ? c : p.D - 1;  // an idle lane loads a valid channel
  const int L = p.H * p.W;
  const int code = (p.kinds >> (2 * k)) & 3;  // 0 row_f, 1 col_f, 2 row_r, 3 col_r
  const bool reverse = code >= 2, column = code & 1;
  const int seg_len = column ? p.H : p.W;
  const int n_seg = column ? p.W : p.H;
  const int chunk = p.segs * seg_len;
  const int n_chunks = (n_seg + p.segs - 1) / p.segs;
  const int t0 = j * chunk;
  const int cnt = j < n_chunks ? min(chunk, L - t0) : 0;
  const long long row0 = static_cast<long long>(img) * L;
  const T* u = static_cast<const T*>(p.u);
  const T* Bp = static_cast<const T*>(p.Bp);
  const T* Cp = static_cast<const T*>(p.Cp);

  __syncthreads();  // the block's previous item is done with the shared arrays
  if (RANK) {
    for (int i = j * CH + tx; i < p.R * CH; i += nthreads) {
      const int r = i / CH, lane = i % CH;
      wdt_s[i] = c0 + lane < p.D
                     ? p.w_dt[(static_cast<long long>(k) * p.R + r) * p.D + c0 + lane]
                     : 0.f;
    }
    __syncthreads();
  }
  float a_kn[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
    a_kn[n] = n < p.N ? p.A[(static_cast<long long>(k) * p.N + n) * p.D + cc] : 0.f;
  const float bias_k = p.bias[k * p.D + cc];
  const float d_k = p.Dk ? p.Dk[k * p.D + cc] : 0.f;
  if constexpr (STAGED) {
    // the item's u, B, C and rank values (16-byte loads where rows allow),
    // then every position's delta for its channels, all threads at once
    float* us_s = dl_s + L * CH;   // [L][CH]
    float* bc_s = us_s + L * CH;   // [L][2]
    float* rk_s = bc_s + 2 * L;    // [L][R]
    const T* ranks = static_cast<const T*>(p.ranks);
    if (sizeof(T) == 4 && p.R % 4 == 0 && p.rank_stride % 4 == 0 && p.D % 4 == 0 &&
        c0 + CH <= p.D) {
      for (int e = j * CH + tx; e < L * p.R / 4; e += nthreads) {
        const int l = e / (p.R / 4), r = e % (p.R / 4) * 4;
        float4 v =
            *reinterpret_cast<const float4*>(ranks + (row0 + l) * p.rank_stride + k * p.R + r);
        if (p.round_rank)
          v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
        *reinterpret_cast<float4*>(rk_s + l * p.R + r) = v;
      }
      for (int e = j * CH + tx; e < L * CH / 4; e += nthreads) {
        const int l = e / (CH / 4), ch = e % (CH / 4) * 4;
        *reinterpret_cast<float4*>(us_s + l * CH + ch) =
            *reinterpret_cast<const float4*>(u + (row0 + l) * p.D + c0 + ch);
      }
    } else {
      for (int e = j * CH + tx; e < L * p.R; e += nthreads) {
        const float v = to_f32(ranks[(row0 + e / p.R) * p.rank_stride + k * p.R + e % p.R]);
        rk_s[e] = p.round_rank ? round_bf16(v) : v;
      }
      for (int e = j * CH + tx; e < L * CH; e += nthreads)
        us_s[e] = to_f32(u[(row0 + e / CH) * p.D + min(c0 + e % CH, p.D - 1)]);
    }
    for (int e = j * CH + tx; e < 2 * L; e += nthreads) {
      const long long o = (row0 + e / 2) * p.bc_stride + k * p.bc_k_stride;
      bc_s[e] = to_f32(e % 2 ? Cp[o] : Bp[o]);
    }
    __syncthreads();
    // delta = softplus(rank values (L x R) . w_dt slice (R x CH) + bias) on
    // the tensor cores, a warp per 16 positions: bfloat16 products where
    // the rank values are rounded to bfloat16 (exact: w_dt is packed in
    // bfloat16 too), else TF32 in three parts
    constexpr int NT = CH / 8;
    const int warp = (j * CH + tx) / 32;
    auto a = [&](int m, int kk) { return rk_s[m * p.R + kk]; };
    auto b = [&](int kk, int n) { return wdt_s[kk * CH + n]; };
    for (int mt = warp; mt < (L + 15) / 16; mt += nthreads / 32) {
      float acc[NT][4] = {};
      if (p.round_rank) mma_tiles<Prec::kBF16, NT>(acc, a, b, mt * 16, 0, L, CH, 0, p.R);
      else mma_tiles<Prec::kTF32x3, NT>(acc, a, b, mt * 16, 0, L, CH, 0, p.R);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = tile_row(mt * 16, e), n = tile_col(8 * jn, e);
          if (m < L)
            dl_s[m * CH + n] = softplus20(acc[jn][e] + p.bias[k * p.D + min(c0 + n, p.D - 1)]);
        }
    }
    __syncthreads();
  }

  // row (image offset included) of the n-th position this thread walks
  auto row_of = [&](int i) -> long long {
    const int t = reverse ? t0 + cnt - 1 - i : t0 + i;
    return row0 + (column ? (t % p.H) * p.W + t / p.H : t);
  };
  auto delta_of = [&](long long row) -> float {
    if constexpr (STAGED) return dl_s[(row - row0) * CH + tx];
    float z;
    if (RANK) {
      const T* rk = static_cast<const T*>(p.ranks) + row * p.rank_stride + k * p.R;
      z = 0.f;
      for (int r = 0; r < p.R; ++r) {
        const float v = to_f32(rk[r]);
        z = fmaf(p.round_rank ? round_bf16(v) : v, wdt_s[r * CH + tx], z);
      }
    } else {
      z = to_f32(static_cast<const T*>(p.dts)[row * p.dt_stride + static_cast<long long>(k) * p.D + cc]);
    }
    return softplus20(z + bias_k);
  };
  auto u_at = [&](long long row) -> float {
    if constexpr (STAGED) return dl_s[L * CH + (row - row0) * CH + tx];
    return to_f32(u[row * p.D + cc]);
  };
  auto bc_at = [&](bool is_c, long long row, int n) -> float {  // B (or C) at state n
    if constexpr (STAGED) return dl_s[2 * L * CH + 2 * (row - row0) + is_c];
    return to_f32((is_c ? Cp : Bp)[row * p.bc_stride + k * p.bc_k_stride + n * p.bc_n_stride]);
  };

  // 1. the chunk's pair (prod a, h from a zero state) for every state
  float h[MAXN], prod[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    h[n] = 0.f;
    prod[n] = 1.f;
  }
  for (int i = 0; i < cnt; ++i) {
    const long long row = row_of(i);
    const float delta = delta_of(row);
    const float du = delta * u_at(row);
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < p.N) {
        const float a = expf(delta * a_kn[n]);
        h[n] = fmaf(a, h[n], du * bc_at(false, row, n));
        prod[n] *= a;
      }
    }
  }
  // 2. the state entering each chunk, state by state: thread j == 0 of each
  //    channel chains the chunks in traversal order
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n < p.N) {  // uniform over the block: every thread reaches the barriers
      prod_s[j * CH + tx] = prod[n];
      loc_s[j * CH + tx] = h[n];
      __syncthreads();
      if (j == 0) {
        float carry = 0.f;
        for (int m = 0; m < n_chunks; ++m) {
          const int jj = reverse ? n_chunks - 1 - m : m;
          cin_s[jj * CH + tx] = carry;
          carry = fmaf(prod_s[jj * CH + tx], carry, loc_s[jj * CH + tx]);
        }
      }
      __syncthreads();
      h[n] = cin_s[j * CH + tx];
    }
  }
  // 3. the chunk again from its state: this kind's part
  float* part = p.part + static_cast<long long>(k) * p.n_img * L * p.D;
  for (int i = 0; i < cnt; ++i) {
    const long long row = row_of(i);
    const float delta = delta_of(row);
    const float uu = u_at(row);
    const float du = delta * uu;
    float y = 0.f;
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < p.N) {
        h[n] = fmaf(expf(delta * a_kn[n]), h[n], du * bc_at(false, row, n));
        y = fmaf(bc_at(true, row, n), h[n], y);
      }
    }
    if (p.Dk) y = fmaf(uu, d_k, y);
    if (p.round_part) y = round_bf16(y);
    if (active) part[row * p.D + c] = y;
  }
}

}  // namespace xfm
