// Fused FAST-9/16 corner score + 3x3 non-maximum suppression (+ optional
// separable Gaussian blur) for Hopper (sm_90a).
//
// Replaces mageslam_tpu/ops/fast_pallas.py: detect_and_smooth (the
// frontend's per-frame image stage) and detect (score + NMS only).  Both
// entry points share one kernel body, templated on whether the blur runs.
//
// What bounds it: a stencil over one float32 image that moves 12 bytes per
// pixel (4 read, 4 + 4 written) against 75 to 250 float32 operations per
// pixel, depending on how many pixels are corner candidates.  By bytes the
// card needs 1.3 us for 480x752; the operations are minima, maxima and
// compares, which an H100 issues at half the rate of its multiply-adds, and
// at that rate they need about as long: the kernel sits on the ridge.  What
// it pays for in practice, measured stage by stage on the card, is the
// half-rate integer/min-max pipe and the shared-memory pipe, so the design
// spends as little of both as it can:
//
// * Exact early-out.  Rounding is monotone, so min and max commute with
//   the subtractions: the bright arc score is fl(fl(B - center) - thr) with
//   B the max over the 16 arcs of the arc's minimum raw value, and the dark
//   one the same on the negated values (fl(a - b) = -fl(b - a)).  Every arc
//   of 9 holds an antipodal pair (k, k+8), so a pixel whose best pair
//   minimum P has fl(P - center) <= thr, and whose best pair maximum Q has
//   fl(Q - center) >= -thr, scores exactly 0 and never runs the arc scan.
//   A thread tests four adjacent pixels out of 16-byte shared loads.
// * Compaction.  Each warp appends its candidates, one entry per surviving
//   polarity, to its own list (a prefix sum by shuffles) and scans the list
//   at once with full lanes; no block barrier separates the two, so the
//   warps drift apart and one's loads overlap another's arithmetic.
// * The arc scan runs on order-preserving integer keys of the pixels
//   (written beside the float window when the tile is loaded) with
//   Hopper's three-input integer min/max: 40 operations for the 16 arcs
//   instead of 80.  The dark polarity complements the keys; that and the
//   sign changes are multiplies by +-1, which go to the otherwise idle
//   multiply pipes.  The NMS compares the scores' bits (all >= 0) the same
//   way.
// * One block of 256 threads per 32x16 output tile.  The window (tile + 4)
//   comes in by 16-byte cp.async on tiles inside the image and by indexed
//   reflect-101 loads, all in flight at once, on border tiles or unaligned
//   images.  Window rows are dense, so neighbouring threads read
//   neighbouring 16-byte chunks and never collide on a bank.  Six warps
//   score while two run the horizontal blur pass; the NMS and the vertical
//   pass then share the block, four pixels a thread, with float4 stores
//   (scalar when a row or pointer is not 16-byte aligned).
//
// Exactness: the score uses only subtraction, min and max and equals the
// plain version bit for bit.  The blur multiplies and adds with
// __fmul_rn/__fadd_rn in the plain version's order (taps in order,
// horizontal pass first), so no multiply-add is contracted into an FMA and
// the result equals the plain float32 version.  Build without
// -use_fast_math (flush-to-zero would break the early-out's argument).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TW = 32;            // output tile width
constexpr int TH = 16;            // output tile height
constexpr int NT = 256;           // threads per block
constexpr int R = 4;              // apron: 3 for the circle + 1 for NMS
constexpr int IW = TW + 2 * R;    // shared input window; its rows are dense,
constexpr int IH = TH + 2 * R;    // so consecutive 4-pixel groups are
                                  // consecutive 16-byte chunks
constexpr int PADX = 4;           // one chunk before the first and after the
                                  // last window row: the early-out reads one
                                  // chunk beyond its group, into the
                                  // neighbouring row or these pads
constexpr int NIN = IH * IW + 2 * PADX;
constexpr int GW = IW / 4;        // 4-pixel groups per window row
constexpr int SW = TW + 2;        // raw-score ring tile (tile + 1 pixel)
constexpr int SH = TH + 2;
constexpr int SSTR = SW + 3;      // score row stride, = 1 mod 4: the NMS
                                  // reads of four rows hit distinct banks
constexpr int MAXK = 7;           // blur taps (ksize <= 7, zero-padded)
constexpr int BP = MAXK / 2;      // blur apron
constexpr int HB = TH + 2 * BP;   // rows of the horizontal blur pass
constexpr int NG = TH * TW / 4;   // float4 groups of the output tile
constexpr int NT_SCORE = 192;     // threads that score: six warps; the
                                  // other two blur rows
constexpr int WLIST = 32 * 8;     // a warp's candidates: 4 pixels x 2 a lane
constexpr int NLOAD = (IH * IW + NT - 1) / NT;   // border loads a thread

static_assert(IH * IW <= 1024 && SH * SSTR <= 1024,
              "list entries hold two 10-bit offsets");

__constant__ float c_taps[MAXK];

// reflect-101 index of i in [0, n), exact for the coordinates the kernel
// needs (at most 4 outside the image, three reflections cover n >= 2);
// farther ones, which only pad ragged tiles, are clamped into range
__device__ __forceinline__ int reflect101(int i, int n) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    i = i < 0 ? -i : i;
    i = i >= n ? 2 * (n - 1) - i : i;
  }
  return min(max(i, 0), n - 1);
}

// the 16 circle pixels, 12 o'clock clockwise; c points at the centre in the
// shared input window
template <typename T>
__device__ __forceinline__ void ring_values(const T* c, T (&v)[16]) {
  v[0] = c[-3 * IW];
  v[1] = c[-3 * IW + 1];
  v[2] = c[-2 * IW + 2];
  v[3] = c[-IW + 3];
  v[4] = c[3];
  v[5] = c[IW + 3];
  v[6] = c[2 * IW + 2];
  v[7] = c[3 * IW + 1];
  v[8] = c[3 * IW];
  v[9] = c[3 * IW - 1];
  v[10] = c[2 * IW - 2];
  v[11] = c[IW - 3];
  v[12] = c[-3];
  v[13] = c[-IW - 3];
  v[14] = c[-2 * IW - 2];
  v[15] = c[-3 * IW - 1];
}

// twelve floats from a 16-byte aligned shared address
__device__ __forceinline__ void load12(const float* p, float (&v)[12]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = q[0], b = q[1], c = q[2];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = c.x; v[9] = c.y; v[10] = c.z; v[11] = c.w;
}

// one antipodal pair (a, b) into the best pair minimum / pair maximum
__device__ __forceinline__ void pair_test(float a, float b, float& hi,
                                          float& lo) {
  hi = fmaxf(hi, fminf(a, b));
  lo = fminf(lo, fmaxf(a, b));
}

// Order-preserving integer key of a float's bits: signed-integer order of
// the keys is the float order (-0 below +0; NaN is not ordered).  The map is
// its own inverse.
__device__ __forceinline__ int order_key(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// max over the 16 cyclic length-9 arcs of the arc minimum, on keys, with
// Hopper's three-input integer min/max: m3[k] = min e[k..k+2],
// arc(k) = min(m3[k], m3[k+3], m3[k+6]); 40 operations instead of 80
__device__ __forceinline__ int arc_max_min(const int (&e)[16]) {
  int m3[16], m9[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    m3[k] = __vimin3_s32(e[k], e[(k + 1) & 15], e[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k)
    m9[k] = __vimin3_s32(m3[k], m3[(k + 3) & 15], m3[(k + 6) & 15]);
  const int a0 = __vimax3_s32(m9[0], m9[1], m9[2]);
  const int a1 = __vimax3_s32(m9[3], m9[4], m9[5]);
  const int a2 = __vimax3_s32(m9[6], m9[7], m9[8]);
  const int a3 = __vimax3_s32(m9[9], m9[10], m9[11]);
  const int a4 = __vimax3_s32(m9[12], m9[13], m9[14]);
  return max(__vimax3_s32(a0, a1, a2), __vimax3_s32(a3, a4, m9[15]));
}

// seven taps over v[0..6], in tap order, no FMA
__device__ __forceinline__ float blur7(const float* v) {
  float acc = __fmul_rn(v[0], c_taps[0]);
#pragma unroll
  for (int k = 1; k < MAXK; ++k)
    acc = __fadd_rn(acc, __fmul_rn(v[k], c_taps[k]));
  return acc;
}

__device__ __forceinline__ void store4(float* __restrict__ out, int gy, int gx,
                                       int w, bool vec, const float (&o)[4]) {
  float* p = out + (size_t)gy * w + gx;
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (gx + q < w) p[q] = o[q];
  }
}

// vec: rows of all three images are 16-byte aligned (w % 4 == 0 and aligned
// base pointers), so cp.async and float4 stores are allowed
template <bool kBlur>
__global__ void __launch_bounds__(NT)
fast_kernel(const float* __restrict__ img, float* __restrict__ score_out,
            float* __restrict__ smooth_out, int h, int w, float thr,
            int vec) {
  __shared__ __align__(16) float s_in[NIN];
  __shared__ __align__(16) float s_hb[kBlur ? HB * TW : 4];
  __shared__ float s_score[SH * SSTR];
  __shared__ __align__(16) int s_key[IH * IW];   // the window as order keys
  __shared__ unsigned s_list[(NT_SCORE / 32) * WLIST];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  // window (ly, lx) is image (y0 - R + ly, x0 - R + lx)
  float* const win = s_in + PADX;

  // 1. input window: tile + apron.  The raw scores are zeroed while the
  // loads are in flight.
  const bool inside = vec && x0 >= R && y0 >= R && x0 + TW + R <= w &&
                      y0 + TH + R <= h;
  if (inside) {
    for (int t = tid; t < IH * GW; t += NT) {
      const int ly = t / GW, c4 = t - ly * GW;
      __pipeline_memcpy_async(
          &win[4 * t],
          img + (size_t)(y0 - R + ly) * w + (x0 - R + 4 * c4), 16);
    }
    __pipeline_commit();
    for (int i = tid; i < SH * SSTR; i += NT) s_score[i] = 0.0f;
    __pipeline_wait_prior(0);
    // a thread sees its own copies now: keys of the chunks it fetched
    for (int t = tid; t < IH * GW; t += NT) {
      const int4 f = *reinterpret_cast<const int4*>(&win[4 * t]);
      *reinterpret_cast<int4*>(&s_key[4 * t]) = make_int4(
          order_key(f.x), order_key(f.y), order_key(f.z), order_key(f.w));
    }
  } else {
    // border tile or unaligned image: reflect-101 indexing, every load of
    // a thread in flight before the first is stored
    float tmp[NLOAD];
#pragma unroll
    for (int k = 0; k < NLOAD; ++k) {
      const int i = min(tid + k * NT, IH * IW - 1);
      const int ly = i / IW, lx = i - ly * IW;
      tmp[k] = img[(size_t)reflect101(y0 + ly - R, h) * w +
                   reflect101(x0 + lx - R, w)];
    }
    for (int i = tid; i < SH * SSTR; i += NT) s_score[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < NLOAD; ++k) {
      const int i = tid + k * NT;
      if (i < IH * IW) {
        win[i] = tmp[k];
        s_key[i] = order_key(__float_as_int(tmp[k]));
      }
    }
  }
  __syncthreads();

  // 2 + 3. Score over the ring tile, warp by warp with no block barrier in
  // between, so that one warp's shared-memory reads overlap another's
  // arithmetic; the last two warps meanwhile run the horizontal blur pass.
  if (tid < NT_SCORE) {
    unsigned* const wlist = s_list + (tid >> 5) * WLIST;
    for (int base = 0; base < SH * GW; base += NT_SCORE) {
      // 2. early-out, four adjacent pixels a thread: group (sy, g) covers
      // ring row sy and window columns 4g .. 4g+3.  With P the best pair
      // minimum and Q the best pair maximum of the raw ring values, a
      // pixel is a bright candidate iff fl(P - center) > thr and a dark
      // one iff fl(Q - center) < -thr.
      const int t = base + tid;
      const int sy = t / GW, g = t - sy * GW;
      unsigned flags = 0;   // bit q: pixel q bright; bit 4 + q: pixel q dark
      if (t < SH * GW) {
        // centre row of the group in the window, one chunk to the left
        const float* c = &win[(sy + R - 1) * IW + 4 * g - 4];
        float a[12], b[12], hi[4], lo[4];
        load12(c - 3 * IW, a);
        load12(c + 3 * IW, b);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hi[q] = fminf(a[4 + q], b[4 + q]);
          lo[q] = fmaxf(a[4 + q], b[4 + q]);
          pair_test(a[5 + q], b[3 + q], hi[q], lo[q]);
          pair_test(a[3 + q], b[5 + q], hi[q], lo[q]);
        }
        load12(c - 2 * IW, a);
        load12(c + 2 * IW, b);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pair_test(a[6 + q], b[2 + q], hi[q], lo[q]);
          pair_test(a[2 + q], b[6 + q], hi[q], lo[q]);
        }
        load12(c - IW, a);
        load12(c + IW, b);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pair_test(a[7 + q], b[1 + q], hi[q], lo[q]);
          pair_test(a[1 + q], b[7 + q], hi[q], lo[q]);
        }
        load12(c, a);
        const int gy = y0 + sy - 1;
        const bool row_ok = gy >= 3 && gy < h - 3;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pair_test(a[7 + q], a[1 + q], hi[q], lo[q]);
          const float ctr = a[4 + q];
          const int sx = 4 * g + q - (R - 1);   // ring column
          const int gx = x0 + sx - 1;
          if (row_ok && sx >= 0 && sx < SW && gx >= 3 && gx < w - 3) {
            if (__fsub_rn(hi[q], ctr) > thr) flags |= 1u << q;
            if (__fsub_rn(lo[q], ctr) < -thr) flags |= 16u << q;
          }
        }
      }
      // compact the warp's candidates into its list, one entry per
      // surviving polarity, in lane order (neighbouring entries are
      // neighbouring pixels, so the scan's reads do not collide); a
      // prefix sum by shuffles counts the entries before a lane's and keeps
      // the shared-memory pipe out of the dependency
      const int cnt = __popc(flags);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      int pos = incl - cnt;
      // an entry: window offset | score offset << 10 | dark << 20
      const int woff0 = (sy + R - 1) * IW + 4 * g;
      const int soff0 = sy * SSTR + 4 * g - (R - 1);
      while (flags) {
        const int bit = __ffs(flags) - 1, q = bit & 3;
        flags &= flags - 1;
        wlist[pos++] = (woff0 + q) | ((soff0 + q) << 10) | ((bit >> 2) << 20);
      }
      __syncwarp();
      // 3. arc scan over the list with full lanes, on the keys, one code
      // path for both polarities: the dark one runs on the complemented
      // keys (the order reversed), and both scale by +-1 on the multiply
      // pipes, which the min/max leave idle.  A pixel listed for both
      // polarities keeps the larger score.
      for (int j = lane; j < total; j += 32) {
        const unsigned ent = wlist[j];
        const int woff = ent & 1023, soff = (ent >> 10) & 1023;
        const bool dark = (ent >> 20) != 0;
        const int ks = dark ? -1 : 1, kt = dark ? -1 : 0;   // ~k = -k - 1
        const float fs = dark ? -1.0f : 1.0f;
        int v[16];
        ring_values(&s_key[woff], v);
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = v[k] * ks + kt;
        const int best = arc_max_min(v) * ks + kt;   // key of the raw extreme
        const float ext = __int_as_float(order_key(best));
        const float sc = __fsub_rn(
            __fsub_rn(__fmul_rn(ext, fs), __fmul_rn(win[woff], fs)), thr);
        // scores are >= 0 here, where float order is integer order; a
        // negative sc is a negative integer and leaves the 0
        atomicMax(reinterpret_cast<int*>(&s_score[soff]), __float_as_int(sc));
      }
      __syncwarp();
    }
  } else if (kBlur) {
    // 4a. horizontal pass over the tile's rows +- BP, four outputs a thread
    for (int t = tid - NT_SCORE; t < HB * (TW / 4); t += NT - NT_SCORE) {
      const int ry = t / (TW / 4), j = t - ry * (TW / 4);
      // output column x reads window columns x + R - BP + k, k = 0..6
      float v[12], o[4];
      load12(&win[(ry + R - BP) * IW + 4 * j], v);
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = blur7(&v[q + R - BP]);
      *reinterpret_cast<float4*>(&s_hb[ry * TW + 4 * j]) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();

  // 5. outputs, four adjacent pixels a thread: role 0 is the NMS, role 1
  // the vertical blur pass
  for (int t = tid; t < (kBlur ? 2 : 1) * NG; t += NT) {
    const int role = t / NG, g = t - role * NG;
    const int lx = (g % (TW / 4)) * 4, ly = g / (TW / 4);
    const int gx = x0 + lx, gy = y0 + ly;
    if (gx >= w || gy >= h) continue;
    float o[4];
    if (role == 0) {
      // keep the score where it is the 3x3 maximum (ties kept); scores
      // are >= 0, so their bits compare as integers, three at a time
      const int* sc = reinterpret_cast<const int*>(s_score);
      int r[3][6], cm[6];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 6; ++dx)
          r[dy][dx] = sc[(ly + dy) * SSTR + lx + dx];
#pragma unroll
      for (int dx = 0; dx < 6; ++dx)
        cm[dx] = __vimax3_s32(r[0][dx], r[1][dx], r[2][dx]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = __vimax3_s32(cm[q], cm[q + 1], cm[q + 2]);
        const int c = r[1][q + 1];
        o[q] = (c >= m && c > 0) ? __int_as_float(c) : 0.0f;
      }
      store4(score_out, gy, gx, w, vec != 0, o);
    } else {
      // 4b. vertical pass
      float col[4][MAXK];
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        const float4 a =
            *reinterpret_cast<const float4*>(&s_hb[(ly + k) * TW + lx]);
        col[0][k] = a.x;
        col[1][k] = a.y;
        col[2][k] = a.z;
        col[3][k] = a.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = blur7(col[q]);
      store4(smooth_out, gy, gx, w, vec != 0, o);
    }
  }
}

// same grid and block, no work: the floor that any launch of this shape pays
__global__ void __launch_bounds__(NT) floor_kernel() {}

dim3 grid_for(int h, int w) {
  return dim3((w + TW - 1) / TW, (h + TH - 1) / TH);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Copies MAXK float32 taps (zero-padded, centred) into constant memory.
int fast_set_taps(const float* taps_host, void* stream) {
  cudaMemcpyToSymbolAsync(c_taps, taps_host, MAXK * sizeof(float), 0,
                          cudaMemcpyHostToDevice,
                          static_cast<cudaStream_t>(stream));
  cudaError_t err = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int fast_detect_and_smooth(const void* img, void* score, void* smooth, int h,
                           int w, float thr, void* stream) {
  const int vec = (w % 4 == 0) && aligned16(img) && aligned16(score) &&
                  aligned16(smooth);
  fast_kernel<true><<<grid_for(h, w), NT, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(score),
      static_cast<float*>(smooth), h, w, thr, vec);
  return static_cast<int>(cudaGetLastError());
}

int fast_detect(const void* img, void* score, int h, int w, float thr,
                void* stream) {
  const int vec = (w % 4 == 0) && aligned16(img) && aligned16(score);
  fast_kernel<false><<<grid_for(h, w), NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(score), nullptr, h,
      w, thr, vec);
  return static_cast<int>(cudaGetLastError());
}

// Launches an empty kernel on the grid the FAST kernel uses for an (h, w)
// image: the measuring reference for what a launch of that shape costs.
int fast_launch_floor(int h, int w, void* stream) {
  floor_kernel<<<grid_for(h, w), NT, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
