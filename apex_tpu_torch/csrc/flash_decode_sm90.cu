// Paged decode attention for Hopper (sm_90a), over a bf16 pool or a
// quantized int8 / fp8 e4m3 pool: the route for head dim 128
// (flash_decode.cu keeps the fp32 pool and head dim 8).
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_flash_decode_pallas
// (body _make_decode_kernel, both its plain and its quantized=True form):
// attention of the last q_len positions of each request against that
// request's K/V, which lives in fixed-size pages of a shared pool found
// through a page table.  Query row i sees columns [0, kv_len - q_len + i];
// a row whose window is empty returns exact zeros; a page id outside the
// pool traps.  Arithmetic as the TPU kernel's: s = q.k accumulated in fp32;
// on a bf16 pool P is rounded to bf16 before P.V (pexp.astype(v.dtype)),
// on a quantized pool K and V are widened in registers as
// float(code) * scale, with one fp32 scale per (page, slot, head), and P
// stays fp32.  Only the narrow codes and the 4-byte scales cross HBM.
//
// What bounds it on an H100: bytes.  A decode step reads each live K/V
// row once (bf16: 512 bytes a column and head at d = 128; int8 / fp8: 256
// plus 8 bytes of scales) and does 4 d flops per visible (row, column),
// about one flop per byte, far below the ~295 flops per byte where the
// tensor cores become the limit.  At the serving shapes the work is small
// (8 requests x 16 heads), so the design is about the latency and the
// parallelism of the page walk:
//
// * No idle rows.  A key row of the pool is 16-byte vectors, one a lane:
//   LPR = D * sizeof(code) / 16 lanes hold a key row (16 at bf16, 8 at one
//   byte), so a warp scores 32 / LPR keys at once against q held in
//   registers, and a block works for one query row, not for a 16-row
//   tile (a longer q_len gives each row its own blocks).
// * A split walk.  A request's visible columns are cut into splits of
//   kSplitElems / D columns, rounded down to whole pages (at least one
//   page); one block takes a split.  Inside it, the table's entries for
//   the whole split are read and turned into row offsets up front, in
//   shared memory, then the 4 warps fold tiles of kTile columns, tile t
//   to warp t % kWarps.  Each lane starts all the 16-byte loads of its
//   tile's keys and values (and their scales) before any arithmetic, and
//   with ~5 blocks an SM resident many pages are in flight at once.
// * A fixed order.  The split, the tiles and the warps follow from the
//   request's own kv_len, q_len, page_size and d, never from the batch or
//   the card.  A warp's key groups are added by a butterfly, the warps in
//   warp order through shared memory, and the splits in split order by a
//   second kernel (only where the table's reach can hold more than one
//   split), launched as a programmatic dependent launch so that its
//   launch overlaps the first kernel.  A row's result therefore depends
//   on its own request's pages only, bit for bit, whatever else is in
//   the batch: the serving engine's batched == sequential contract.
//
// apex_tpu_torch/ops/attention.py::decode_partition states the split
// and the warps' tiles for the tests.
//
// Layout: q [B, H, q_len, d] and o [B, H, q_len, d] with any strides whose
// last one is 1 (the engine hands in a view of the fused qkv projection
// and reads o back in [B, q_len, H, d] order); pools [n_pages, page_size,
// H, d] with strides (page, slot, head) shared by K and V; scales
// [n_pages, page_size, H] fp32 with strides shared by K's and V's;
// page_table [B, p_max] int32; kv_len [B] int32.

#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;            // columns a warp folds at a time
constexpr int kSplitElems = 16384;   // a split's columns x the head dim
constexpr int kD = 128;              // the head dim of every instance

// 16 bytes of pool codes widened to fp32.
template <typename KV>
struct Pool;

template <>
struct Pool<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr bool kQuant = false;
  __device__ static void widen(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

template <>
struct Pool<int8_t> {
  static constexpr int N = 16;
  static constexpr bool kQuant = true;
  __device__ static void widen(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
  }
};

template <>
struct Pool<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  static constexpr bool kQuant = true;
  __device__ static void widen(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // two e4m3 codes -> two halves (exact) -> two floats
        const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * j)) & 0xffffu), __NV_E4M3);
        const float2 x = __half22float2(__half2(r));
        f[4 * i + 2 * j] = x.x;
        f[4 * i + 2 * j + 1] = x.y;
      }
  }
};

// Element strides: q (b, h, row), pools (page, slot, head), o (b, h, row),
// scales (page, slot, head).
struct Strides {
  int64_t qb, qh, qr, pp, ps, ph, ob, oh, orow, sp, ss, sh;
};

// The partition, on the host and on the device alike: a split's columns,
// the columns query row r of q_len may see (cols <= kv - q_len + r,
// capped at the table's reach), and the row's number of splits (at least
// one, so an empty window still writes its zeros).
__host__ __device__ inline int split_columns(int page_size) {
  const int pages = kSplitElems / kD / page_size;
  return (pages > 1 ? pages : 1) * page_size;
}

__host__ __device__ inline int row_columns(int kv, int q_len, int r, int reach) {
  const int cols = kv - q_len + r + 1;
  return cols < 0 ? 0 : (cols < reach ? cols : reach);
}

__host__ __device__ inline int n_splits(int ncols, int split_cols) {
  const int n = (ncols + split_cols - 1) / split_cols;
  return n > 1 ? n : 1;
}

__device__ __forceinline__ uint4 load_vec(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float keep_or_round(float p, bool round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16(p)) : p;
}

// One split of one request, head and query row: the split's (m, l, acc)
// over its columns, written to o (normalised) when the row has one
// split, else to the workspace for decode_merge.
template <typename Q, typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_split(const Q* __restrict__ q, const KV* __restrict__ kp, const KV* __restrict__ vp,
                 const float* __restrict__ ks, const float* __restrict__ vs, Q* __restrict__ o,
                 float* __restrict__ work, const int* __restrict__ page_table,
                 const int* __restrict__ kv_len, int q_len, int p_max, int page_size,
                 int n_pages, int max_splits, Strides st, float scale) {
  using P = Pool<KV>;
  constexpr int E = P::N;         // codes a lane holds: 16 bytes
  constexpr int LPR = kD / E;     // lanes a key row
  constexpr int G = 32 / LPR;     // key rows a warp scores at once
  constexpr int U = kTile / G;    // keys a lane loads a tile
  constexpr int QV = 16 / sizeof(Q);
  static_assert(kD % E == 0 && 32 % LPR == 0 && kTile % G == 0, "tile shape");
  extern __shared__ int64_t offs[];  // [split cols] K/V row offsets, then scale offsets
  __shared__ float part[kWarps][kD + 2];

  // the merge pass (decode_merge) may start launching now: it waits for
  // this grid's memory before it reads any
  asm volatile("griddepcontrol.launch_dependents;");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / LPR, c = lane % LPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z / q_len;
  const int r = blockIdx.z % q_len;
  const int kv = kv_len[b];
  const int ncols = row_columns(kv, q_len, r, p_max * page_size);  // cols [0, ncols) visible
  const int split_cols = split_columns(page_size);
  const int ns = n_splits(ncols, split_cols);
  const int split = blockIdx.x;
  if (split >= ns) return;
  const int c0 = split * split_cols;
  const int n = max(0, min(ncols - c0, split_cols));  // this split: cols [c0, c0 + n)

  // the table's entries for the whole split, as row offsets, up front
  int64_t* koff = offs;
  int64_t* soff = offs + split_cols;
  const int* table = page_table + static_cast<int64_t>(b) * p_max;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int col = c0 + j;
    const int page = table[col / page_size];
    // a page id outside the pool is a corrupt table: stop the launch (the
    // caller sees an error), as the plain version's indexing raises
    if (page < 0 || page >= n_pages) __trap();
    const int slot = col % page_size;
    koff[j] = page * st.pp + slot * st.ps + h * st.ph;
    if constexpr (P::kQuant) soff[j] = page * st.sp + slot * st.ss + h * st.sh;
  }
  // this lane's E columns of the q row, widened
  float qf[E];
  const Q* qrow = q + b * st.qb + h * st.qh + r * st.qr + c * E;
#pragma unroll
  for (int k = 0; k < E / QV; ++k) apex::load16(qrow + k * QV, &qf[k * QV]);
  __syncthreads();

  float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  const int n_tiles = (n + kTile - 1) / kTile;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int j0 = t * kTile;
    // every load of the tile in flight before any arithmetic; key u*G + g
    // of the tile belongs to lane group g
    uint4 kr[U], vr[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * G + g;
      ksc[u] = vsc[u] = 0.f;
      if (j < n) {
        const int64_t off = koff[j] + c * E;
        kr[u] = load_vec(kp + off);
        vr[u] = load_vec(vp + off);
        if constexpr (P::kQuant) {
          ksc[u] = __ldg(ks + soff[j]);
          vsc[u] = __ldg(vs + soff[j]);
        }
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      P::widen(kr[u], kf);
      if constexpr (P::kQuant) {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[e] *= ksc[u];
      }
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) a = fmaf(qf[e], kf[e], a);
      // the LPR lanes of a key row each hold a part of q.k
#pragma unroll
      for (int off = 1; off < LPR; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      s[u] = a;
    }
    // the split holds the row's visible columns only: j < n is its window
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = (j0 + u * G + g < n) ? s[u] * scale : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    // a tile that hides every column leaves m at the sentinel: no rescale
    // of nothing, and exp forced to 0 (_masked_exp)
    const float alpha = (m <= kNegInf / 2) ? 0.f : expf(m - m_new);
    float p[U], sum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pu = (m_new <= kNegInf / 2) ? 0.f : expf(s[u] - m_new);
      sum += pu;
      p[u] = keep_or_round(pu, !P::kQuant);
    }
    l = alpha * l + sum;  // this lane group's part; m is the warp's
    m = m_new;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      P::widen(vr[u], vf);
      if constexpr (P::kQuant) {
#pragma unroll
        for (int e = 0; e < E; ++e) vf[e] *= vsc[u];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p[u], vf[e], acc[e]);
    }
  }

  // the warp's lane groups added (a butterfly: every lane gets the same
  // bits), then each warp's (m, l, acc) to shared memory
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) part[warp][2 + c * E + e] = acc[e];
  }
  if (lane == 0) {
    part[warp][0] = m;
    part[warp][1] = l;
  }
  __syncthreads();

  // the warps in warp order
  for (int col = threadIdx.x; col < kD; col += kThreads) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part[w][0]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = part[w][0];
      const float f = (mw <= kNegInf / 2) ? 0.f : expf(mw - mx);
      L += f * part[w][1];
      O += f * part[w][2 + col];
    }
    if (ns == 1) {
      apex::store(o + b * st.ob + h * st.oh + r * st.orow + col, O / (L == 0.f ? 1.f : L));
    } else {
      float* wp = work + (((static_cast<int64_t>(b) * gridDim.y + h) * q_len + r) * max_splits +
                          split) * (kD + 2);
      if (col == 0) {
        wp[0] = mx;
        wp[1] = L;
      }
      wp[2 + col] = O;
    }
  }
}

// The splits of one request, head and query row, added in split order
// (rows with a single split were written by decode_split).
template <typename Q>
__global__ void __launch_bounds__(kD)
    decode_merge(const float* __restrict__ work, Q* __restrict__ o,
                 const int* __restrict__ kv_len, int q_len, int p_max, int page_size,
                 int max_splits, Strides st) {
  // launched as decode_split's programmatic dependent: wait for its
  // grid to finish and its writes to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z, col = threadIdx.x;
  const int ns = n_splits(row_columns(kv_len[b], q_len, row, p_max * page_size),
                          split_columns(page_size));
  if (ns == 1) return;
  const float* wp =
      work + ((static_cast<int64_t>(b) * gridDim.y + h) * q_len + row) * max_splits * (kD + 2);
  float mx = kNegInf;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, wp[s * (kD + 2)]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float ms = wp[s * (kD + 2)];
    const float f = (ms <= kNegInf / 2) ? 0.f : expf(ms - mx);
    L += f * wp[s * (kD + 2) + 1];
    O += f * wp[s * (kD + 2) + 2 + col];
  }
  apex::store(o + b * st.ob + h * st.oh + row * st.orow + col, O / (L == 0.f ? 1.f : L));
}

template <typename Q, typename KV>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, void* o, float* work, const int* page_table,
                   const int* kv_len, int B, int H, int q_len, int p_max, int page_size,
                   int n_pages, int max_splits, const Strides& st, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(int64_t) * split_columns(page_size) * (Pool<KV>::kQuant ? 2 : 1);
  const cudaError_t attr = apex::allow_smem(decode_split<Q, KV>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(max_splits, H, B * q_len);
  decode_split<Q, KV><<<grid, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp), ks, vs,
      static_cast<Q*>(o), work, page_table, kv_len, q_len, p_max, page_size, n_pages,
      max_splits, st, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || max_splits == 1) return err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q_len, H, B);
  cfg.blockDim = dim3(kD);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const float* cwork = work;
  Q* out = static_cast<Q*>(o);
  return cudaLaunchKernelEx(&cfg, decode_merge<Q>, cwork, out, kv_len, q_len, p_max, page_size,
                            max_splits, st);
}

template <typename KV>
int entry(int qdtype, int d, int device, const void* q, const void* k_pages,
          const void* v_pages, const float* k_scale, const float* v_scale, void* o, float* work,
          const int* page_table, const int* kv_len, int B, int H, int q_len, int p_max,
          int page_size, int n_pages, int max_splits, const int64_t* strides, float scale,
          void* stream) {
  const apex::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  if (B <= 0 || H <= 0 || q_len <= 0) return cudaSuccess;
  // the caller sized the workspace by the same partition
  if (d != kD || page_size <= 0 || p_max <= 0 ||
      max_splits != n_splits(p_max * page_size, split_columns(page_size)) ||
      (max_splits > 1 && work == nullptr) ||
      (Pool<KV>::kQuant && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],  strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APEX_DECODE_ARGS                                                                      \
  q, k_pages, v_pages, k_scale, v_scale, o, work, page_table, kv_len, B, H, q_len, p_max, \
      page_size, n_pages, max_splits, st, scale, s
  if (qdtype == 0) return launch<float, KV>(APEX_DECODE_ARGS);
  if (qdtype == 1) return launch<__nv_bfloat16, KV>(APEX_DECODE_ARGS);
#undef APEX_DECODE_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One entry point a pool dtype, so that launches count by pool.  qdtype:
// 0 = float32, 1 = bfloat16 (q and o).  k_scale / v_scale: the quantized
// pools' fp32 scales (null for the bf16 pool).  work: fp32
// [B, H, q_len, max_splits, d + 2] (null when max_splits is 1).  strides:
// int64[12], q (b, h, row), pools (page, slot, head), o (b, h, row),
// scales (page, slot, head), in elements.  Returns cudaGetLastError()
// after the launches.
#define APEX_DECODE_ENTRY(name, KV)                                                          \
  int name(int qdtype, int d, int device, const void* q, const void* k_pages,                \
           const void* v_pages, const float* k_scale, const float* v_scale, void* o,         \
           float* work, const int* page_table, const int* kv_len, int B, int H, int q_len,   \
           int p_max, int page_size, int n_pages, int max_splits, const int64_t* strides,    \
           float scale, void* stream) {                                                      \
    return entry<KV>(qdtype, d, device, q, k_pages, v_pages, k_scale, v_scale, o, work,      \
                     page_table, kv_len, B, H, q_len, p_max, page_size, n_pages, max_splits, \
                     strides, scale, stream);                                                \
  }

APEX_DECODE_ENTRY(flash_decode_sm90, __nv_bfloat16)
APEX_DECODE_ENTRY(flash_decode_sm90_int8, int8_t)
APEX_DECODE_ENTRY(flash_decode_sm90_fp8, __nv_fp8_e4m3)

#undef APEX_DECODE_ENTRY

}  // extern "C"
