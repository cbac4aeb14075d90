// K4 and K5 in float32: the PathNet embedding with its sample mean, the head
// over [e | broadcast_S(ctx)] with its sample moments, and both backwards,
// for f32 activations (TrainConfig.compute_dtype = "float32").
//
//   embedding   h_{i+1} = act_i(h_i . W_i + b_i), h_0 = x[b, s, p, :], i = 0, 1, 2;
//               e = h_3, mean[b, p, :] = sum_s e[b, s, p, :] / S
//   head        z = (e . W1e + ctx . W1c) + b1, h1 = act_0(z),
//               out = act_1(h1 . W2 + b2); moments sum_s out and sum_s out^2
//
// Replaces wcmc_tpu/ops/pathnet_fused.py::_embed_fwd_pallas,
// _embed_bwd_pallas, _head_fwd_pallas and _head_bwd_pallas on f32 inputs:
// there every product is f32 and nothing is rounded between layers, and so
// here.  (The bf16 forms are pathnet_embed*.cu and pathnet_head*.cu.)
//
// What bounds it on the H100: operations.  At KPCN's training shape (8
// images x 8 spp x 128^2 px, 1,048,576 rows) the embedding 36 -> 128^3 is
// 78 GFLOP and the head [128 | 128] -> 256 -> 6 141 GFLOP a forward, 1.2
// and 2.1 ms at the 67 TFLOP/s f32 rate of the CUDA cores; the backwards
// about twice and three times that, with the hidden layers recomputed.
// The bytes (x, e, the cotangents, all f32) are 0.2-0.5 ms.  Every
// product is full f32: a fused multiply-add chain over k from zero per
// output, no TF32.
//
// Design, simple and the same for the four kernels: persistent blocks of
// 256 threads walk tiles of 32 pixels of one image (the plan's grid);
// a tile takes its samples in order, one sample a product of 32 rows.
// Activations live in shared memory, one 32 x C f32 buffer a layer; the
// weights are read from device memory (L1 and L2 keep them: at most 256 KB
// a matrix), row-major, the wrapper passing the transposes the backward
// reads.  A product (mm32, f32_mm.cuh, shared with K10's f32 body) gives
// each thread 4 rows x 4 columns of a 32 x 128 output tile: rows warp + 8 i
// (so a warp's A loads are one broadcast), columns lane + 32 j (so its B
// loads are consecutive); a thread owns the same output elements in every
// call of the same shape, so the epilogue keeps running sums (the mean, the
// moments, the weight gradients) without a barrier or an atomic, summed in
// sample order.
// The backward kernels add each tile's weight and bias gradients into the
// block's f32 partial in device memory (read, add, write by the owning
// thread), and a second launch (reduce_parts) sums the partials in block
// order: two launches repeat bit for bit.
#include <initializer_list>

#include "f32_mm.cuh"
#include "mlp.cuh"

namespace wcmc {

constexpr int kF32MaxWidth = 256;

// ---------------------------------------------------------------------------
// the embedding
// ---------------------------------------------------------------------------

struct EmbedF32 {
  const float* x;     // (B, S, HW, c0)
  const float* ge;    // (B, S, HW, c3) or null (backward)
  const float* gm;    // (B, HW, c3) or null (backward)
  const float* w[3];  // (c_i, c_{i+1}) row-major
  const float* b[3];
  const float* wt[3]; // the transposes (c_{i+1}, c_i) (backward)
  float* e;           // (B, S, HW, c3) (forward)
  float* mean;        // (B, HW, c3) (forward)
  float* dx;          // (B, S, HW, c0) or null (backward)
  float* parts;       // gridDim.x partials of embed_f32_parts floats (backward)
  int B, S, HW;
  int c[4];
  int act[3];
};

__host__ __device__ inline long long embed_f32_parts(const int* c) {
  return (long long)c[0] * c[1] + (long long)c[1] * c[2] + (long long)c[2] * c[3] + c[1] + c[2] +
         c[3];
}

// X, H1, H2 and the fourth buffer (the running sum forward, the cotangent
// g3 backward), 32 rows each.
inline size_t embed_f32_smem(const int* c) {
  size_t n = 0;
  for (int i = 0; i < 4; ++i) n += smem_bytes((size_t)kF32Rows * c[i], 4);
  return n;
}

__global__ void __launch_bounds__(kThreads, 2) pathnet_embed_f32_kernel(EmbedF32 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = a.c[0], c1 = a.c[1], c2 = a.c[2], c3 = a.c[3];
  SmemCarver carve{smem, 0};
  float* X = carve.take<float>(kF32Rows * c0);
  float* H1 = carve.take<float>(kF32Rows * c1);
  float* H2 = carve.take<float>(kF32Rows * c2);
  float* M = carve.take<float>(kF32Rows * c3);
  const int per_image = (a.HW + kF32Rows - 1) / kF32Rows;
  for (int t = blockIdx.x; t < a.B * per_image; t += gridDim.x) {
    const int b = t / per_image, p0 = t % per_image * kF32Rows;
    const int n = min(kF32Rows, a.HW - p0);
    for (int s = 0; s < a.S; ++s) {
      const long long row0 = ((long long)b * a.S + s) * a.HW + p0;
      __syncthreads();  // the last sample's readers are done with X
      load_tile(X, a.x + row0 * c0, n, c0);
      __syncthreads();
      mm32(X, c0, 1, kF32Rows, a.w[0], c1, c1, c0,
           [&](int r, int c, float v) { H1[r * c1 + c] = mlp_act(a.act[0], v + a.b[0][c]); });
      __syncthreads();
      mm32(H1, c1, 1, kF32Rows, a.w[1], c2, c2, c1,
           [&](int r, int c, float v) { H2[r * c2 + c] = mlp_act(a.act[1], v + a.b[1][c]); });
      __syncthreads();
      mm32(H2, c2, 1, kF32Rows, a.w[2], c3, c3, c2, [&](int r, int c, float v) {
        v = mlp_act(a.act[2], v + a.b[2][c]);
        if (r >= n) return;
        a.e[(row0 + r) * c3 + c] = v;
        // the sum over the samples in sample order, by the element's owner
        const float sum = s == 0 ? v : M[r * c3 + c] + v;
        M[r * c3 + c] = sum;
        if (s == a.S - 1) a.mean[((long long)b * a.HW + p0 + r) * c3 + c] = sum / (float)a.S;
      });
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) pathnet_embed_bwd_f32_kernel(EmbedF32 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = a.c[0], c1 = a.c[1], c2 = a.c[2], c3 = a.c[3];
  SmemCarver carve{smem, 0};
  float* X = carve.take<float>(kF32Rows * c0);
  float* H1 = carve.take<float>(kF32Rows * c1);  // h1, then g1
  float* H2 = carve.take<float>(kF32Rows * c2);  // h2, then g2
  float* G3 = carve.take<float>(kF32Rows * c3);  // the cotangent, then g3
  float* part = a.parts + blockIdx.x * embed_f32_parts(a.c);
  float* dw0 = part;
  float* dw1 = dw0 + (size_t)c0 * c1;
  float* dw2 = dw1 + (size_t)c1 * c2;
  float* db0 = dw2 + (size_t)c2 * c3;
  float* db1 = db0 + c1;
  float* db2 = db1 + c2;
  zero_part(part, embed_f32_parts(a.c));
  const int per_image = (a.HW + kF32Rows - 1) / kF32Rows;
  for (int t = blockIdx.x; t < a.B * per_image; t += gridDim.x) {
    const int b = t / per_image, p0 = t % per_image * kF32Rows;
    const int n = min(kF32Rows, a.HW - p0);
    for (int s = 0; s < a.S; ++s) {
      const long long row0 = ((long long)b * a.S + s) * a.HW + p0;
      __syncthreads();  // the partials' zeros, the last sample's readers
      load_tile(X, a.x + row0 * c0, n, c0);
      // g = ge + gmean / S on valid rows (the plain version's order)
      for (int i = threadIdx.x; i < kF32Rows * c3; i += blockDim.x) {
        const int r = i / c3;
        float v = 0.0f;
        if (r < n) {
          if (a.ge != nullptr) v += a.ge[row0 * c3 + i];
          if (a.gm != nullptr) v += a.gm[((long long)b * a.HW + p0) * c3 + i] / (float)a.S;
        }
        G3[i] = v;
      }
      __syncthreads();
      // the hidden layers recomputed
      mm32(X, c0, 1, kF32Rows, a.w[0], c1, c1, c0,
           [&](int r, int c, float v) { H1[r * c1 + c] = mlp_act(a.act[0], v + a.b[0][c]); });
      __syncthreads();
      mm32(H1, c1, 1, kF32Rows, a.w[1], c2, c2, c1,
           [&](int r, int c, float v) { H2[r * c2 + c] = mlp_act(a.act[1], v + a.b[1][c]); });
      __syncthreads();
      if (a.act[2] != 0) {  // the last layer's output recomputed for its gradient
        mm32(H2, c2, 1, kF32Rows, a.w[2], c3, c3, c2, [&](int r, int c, float v) {
          G3[r * c3 + c] = mlp_act_grad(a.act[2], mlp_act(a.act[2], v + a.b[2][c]), G3[r * c3 + c]);
        });
        __syncthreads();
      }
      add_col_sums(db2, G3, c3);
      add_outer(dw2, H2, c2, G3, c3);
      __syncthreads();  // dW2 has read h2
      mm32(G3, c3, 1, kF32Rows, a.wt[2], c2, c2, c3, [&](int r, int c, float v) {
        H2[r * c2 + c] = mlp_act_grad(a.act[1], H2[r * c2 + c], v);
      });
      __syncthreads();
      add_col_sums(db1, H2, c2);
      add_outer(dw1, H1, c1, H2, c2);
      __syncthreads();  // dW1 has read h1
      mm32(H2, c2, 1, kF32Rows, a.wt[1], c1, c1, c2, [&](int r, int c, float v) {
        H1[r * c1 + c] = mlp_act_grad(a.act[0], H1[r * c1 + c], v);
      });
      __syncthreads();
      add_col_sums(db0, H1, c1);
      add_outer(dw0, X, c0, H1, c1);
      if (a.dx != nullptr) {
        mm32(H1, c1, 1, kF32Rows, a.wt[0], c0, c0, c1, [&](int r, int c, float v) {
          if (r < n) a.dx[(row0 + r) * c0 + c] = v;
        });
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the head
// ---------------------------------------------------------------------------

struct HeadF32 {
  const float* e;       // (B, S, HW, ce)
  const float* ctx;     // (B, HW, cc)
  const float* g;       // (B, S, HW, cout), or (B, S, cout, HW) with cmajor, or null (backward)
  const float* gsum;    // (B, HW, cout) or null (backward)
  const float* gsq;     // (B, HW, cout) or null (backward)
  const float* w1;      // (ce + cc, c1): W1e rows, then W1c rows
  const float* b1;
  const float* w2;      // (c1, cout)
  const float* b2;
  const float* w1et;    // (c1, ce) (backward)
  const float* w1ct;    // (c1, cc) (backward)
  const float* w2t;     // (cout, c1) (backward)
  void* out;            // (B, S, HW, cout) or (B, S, cout, HW), f32 or bf16 (forward)
  float* ssum;          // (B, HW, cout) or null (forward)
  float* ssq;
  float* de;            // (B, S, HW, ce) (backward)
  float* dctx;          // (B, HW, cc) (backward)
  float* parts;         // gridDim.x partials of head_f32_parts floats (backward)
  int B, S, HW, ce, cc, c1, cout, act1, act2, out_bf16, cmajor;
};

__host__ __device__ inline long long head_f32_parts(int ce, int cc, int c1, int cout) {
  return (long long)(ce + cc) * c1 + (long long)c1 * cout + c1 + cout;
}

// forward: the context, ctx . W1c, e, h1, the running sum and sum of
// squares (with moments); backward: the context, ctx . W1c, G = sum_s g1,
// e, h1 (then g1), the output cotangent (then gz), gsum, gsq.
inline size_t head_f32_smem(int ce, int cc, int c1, int cout, int moments, int bwd) {
  const size_t r = kF32Rows;
  size_t n = smem_bytes(r * cc, 4) + smem_bytes(r * c1, 4) + smem_bytes(r * ce, 4) +
             smem_bytes(r * c1, 4);
  if (bwd) return n + smem_bytes(r * c1, 4) + 3 * smem_bytes(r * cout, 4);
  return n + (moments ? 2 * smem_bytes(r * cout, 4) : 0);
}

__global__ void __launch_bounds__(kThreads, 2) pathnet_head_f32_kernel(HeadF32 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ce = a.ce, cc = a.cc, c1 = a.c1, co = a.cout;
  const bool moments = a.ssum != nullptr;
  SmemCarver carve{smem, 0};
  float* CX = carve.take<float>(kF32Rows * cc);
  float* ZC = carve.take<float>(kF32Rows * c1);
  float* E = carve.take<float>(kF32Rows * ce);
  float* H1 = carve.take<float>(kF32Rows * c1);
  float* SM = moments ? carve.take<float>(kF32Rows * co) : nullptr;
  float* SQ = moments ? carve.take<float>(kF32Rows * co) : nullptr;
  const float* w1c = a.w1 + (size_t)ce * c1;
  const int per_image = (a.HW + kF32Rows - 1) / kF32Rows;
  for (int t = blockIdx.x; t < a.B * per_image; t += gridDim.x) {
    const int b = t / per_image, p0 = t % per_image * kF32Rows;
    const int n = min(kF32Rows, a.HW - p0);
    const long long pix0 = (long long)b * a.HW + p0;
    __syncthreads();  // the last tile's readers are done with CX and ZC
    load_tile(CX, a.ctx + pix0 * cc, n, cc);
    __syncthreads();
    // ctx . W1c once per pixel
    mm32(CX, cc, 1, kF32Rows, w1c, c1, c1, cc,
         [&](int r, int c, float v) { ZC[r * c1 + c] = v; });
    for (int s = 0; s < a.S; ++s) {
      const long long row0 = ((long long)b * a.S + s) * a.HW + p0;
      __syncthreads();  // ZC written; the last sample's readers are done with E and H1
      load_tile(E, a.e + row0 * ce, n, ce);
      __syncthreads();
      mm32(E, ce, 1, kF32Rows, a.w1, c1, c1, ce, [&](int r, int c, float v) {
        H1[r * c1 + c] = mlp_act(a.act1, (v + ZC[r * c1 + c]) + a.b1[c]);
      });
      __syncthreads();
      mm32(H1, c1, 1, kF32Rows, a.w2, co, co, c1, [&](int r, int c, float v) {
        v = mlp_act(a.act2, v + a.b2[c]);
        if (r >= n) return;
        const long long at = a.cmajor ? (((long long)b * a.S + s) * co + c) * a.HW + p0 + r
                                      : (row0 + r) * co + c;
        if (a.out_bf16) {
          store_f32(static_cast<bf16*>(a.out) + at, v);
        } else {
          static_cast<float*>(a.out)[at] = v;
        }
        if (moments) {  // in sample order, by the element's owner
          const float sum = s == 0 ? v : SM[r * co + c] + v;
          const float sq = s == 0 ? v * v : SQ[r * co + c] + v * v;
          SM[r * co + c] = sum;
          SQ[r * co + c] = sq;
          if (s == a.S - 1) {
            a.ssum[(pix0 + r) * co + c] = sum;
            a.ssq[(pix0 + r) * co + c] = sq;
          }
        }
      });
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) pathnet_head_bwd_f32_kernel(HeadF32 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ce = a.ce, cc = a.cc, c1 = a.c1, co = a.cout;
  SmemCarver carve{smem, 0};
  float* CX = carve.take<float>(kF32Rows * cc);
  float* ZC = carve.take<float>(kF32Rows * c1);
  float* G = carve.take<float>(kF32Rows * c1);   // sum_s g1
  float* E = carve.take<float>(kF32Rows * ce);
  float* H1 = carve.take<float>(kF32Rows * c1);  // h1, then g1
  float* GZ = carve.take<float>(kF32Rows * co);  // the output cotangent, then gz
  float* GS = carve.take<float>(kF32Rows * co);
  float* GQ = carve.take<float>(kF32Rows * co);
  float* part = a.parts + blockIdx.x * head_f32_parts(ce, cc, c1, co);
  float* dw1e = part;
  float* dw1c = dw1e + (size_t)ce * c1;
  float* dw2 = dw1c + (size_t)cc * c1;
  float* db1 = dw2 + (size_t)c1 * co;
  float* db2 = db1 + c1;
  zero_part(part, head_f32_parts(ce, cc, c1, co));
  const float* w1c = a.w1 + (size_t)ce * c1;
  const int per_image = (a.HW + kF32Rows - 1) / kF32Rows;
  for (int t = blockIdx.x; t < a.B * per_image; t += gridDim.x) {
    const int b = t / per_image, p0 = t % per_image * kF32Rows;
    const int n = min(kF32Rows, a.HW - p0);
    const long long pix0 = (long long)b * a.HW + p0;
    __syncthreads();  // the partials' zeros; the last tile's readers
    load_tile(CX, a.ctx + pix0 * cc, n, cc);
    load_tile(GS, a.gsum == nullptr ? nullptr : a.gsum + pix0 * co, n, co);
    load_tile(GQ, a.gsq == nullptr ? nullptr : a.gsq + pix0 * co, n, co);
    for (int i = threadIdx.x; i < kF32Rows * c1; i += blockDim.x) G[i] = 0.0f;
    __syncthreads();
    mm32(CX, cc, 1, kF32Rows, w1c, c1, c1, cc,
         [&](int r, int c, float v) { ZC[r * c1 + c] = v; });
    for (int s = 0; s < a.S; ++s) {
      const long long row0 = ((long long)b * a.S + s) * a.HW + p0;
      __syncthreads();
      load_tile(E, a.e + row0 * ce, n, ce);
      // the output cotangent + gsum on valid rows (the plain version's order)
      for (int i = threadIdx.x; i < kF32Rows * co; i += blockDim.x) {
        const int r = a.cmajor ? i % kF32Rows : i / co, c = a.cmajor ? i / kF32Rows : i % co;
        float v = 0.0f;
        if (r < n && a.g != nullptr)
          v = a.cmajor ? a.g[(((long long)b * a.S + s) * co + c) * a.HW + p0 + r]
                       : a.g[(row0 + r) * co + c];
        GZ[r * co + c] = v + GS[r * co + c];
      }
      __syncthreads();
      mm32(E, ce, 1, kF32Rows, a.w1, c1, c1, ce, [&](int r, int c, float v) {
        H1[r * c1 + c] = mlp_act(a.act1, (v + ZC[r * c1 + c]) + a.b1[c]);
      });
      __syncthreads();
      // h2 recomputed; gz = act'(h2, g + gsum + 2 h2 gsq)
      mm32(H1, c1, 1, kF32Rows, a.w2, co, co, c1, [&](int r, int c, float v) {
        const float h2 = mlp_act(a.act2, v + a.b2[c]);
        const float gg = GZ[r * co + c] + 2.0f * h2 * GQ[r * co + c];
        GZ[r * co + c] = mlp_act_grad(a.act2, h2, gg);
      });
      __syncthreads();
      add_col_sums(db2, GZ, co);
      add_outer(dw2, H1, c1, GZ, co);
      __syncthreads();  // dW2 has read h1
      mm32(GZ, co, 1, kF32Rows, a.w2t, c1, c1, co, [&](int r, int c, float v) {
        H1[r * c1 + c] = mlp_act_grad(a.act1, H1[r * c1 + c], v);
      });
      __syncthreads();
      add_col_sums(db1, H1, c1);
      for (int i = threadIdx.x; i < kF32Rows * c1; i += blockDim.x) G[i] += H1[i];
      add_outer(dw1e, E, ce, H1, c1);
      mm32(H1, c1, 1, kF32Rows, a.w1et, ce, ce, c1, [&](int r, int c, float v) {
        if (r < n) a.de[(row0 + r) * ce + c] = v;
      });
    }
    __syncthreads();  // G summed
    add_outer(dw1c, CX, cc, G, c1);
    mm32(G, c1, 1, kF32Rows, a.w1ct, cc, cc, c1, [&](int r, int c, float v) {
      if (r < n) a.dctx[(pix0 + r) * cc + c] = v;
    });
  }
}

inline bool f32_widths_ok(std::initializer_list<int> widths) {
  for (int c : widths)
    if (c < 1 || c > kF32MaxWidth) return false;
  return true;
}

inline bool acts_ok(std::initializer_list<int> acts) {
  for (int c : acts)
    if (c < 0 || c > 2) return false;
  return true;
}

}  // namespace wcmc

using namespace wcmc;

// The dynamic shared memory of the embedding's f32 bodies (forward and
// backward carve the same) and of the head's (moments: the forward's
// running sums; bwd: the backward's carve): what ops/pathnet_fused.py's
// embed_f32_plan and head_f32_plan total.
extern "C" long long wcmc_pathnet_embed_f32_smem(int c0, int c1, int c2, int c3) {
  const int c[4] = {c0, c1, c2, c3};
  return (long long)embed_f32_smem(c);
}

extern "C" long long wcmc_pathnet_head_f32_smem(int ce, int cc, int c1, int cout, int moments,
                                                int bwd) {
  return (long long)head_f32_smem(ce, cc, c1, cout, moments, bwd);
}

// K4-fwd in f32: x (B, S, HW, c0); w_i (c_i, c_{i+1}) row-major and b_i f32;
// e (B, S, HW, c3) and mean (B, HW, c3) f32; all contiguous; widths 1 to
// 256; act_i 0 linear, 1 relu, 2 leaky relu.  n_blocks: the grid (the
// plan's).
extern "C" int wcmc_pathnet_embed_f32(const void* x, const void* w0, const void* b0,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, void* e, void* mean, int B, int S, int HW,
                                      int c0, int c1, int c2, int c3, int act0, int act1,
                                      int act2, int n_blocks, int device, void* stream) {
  if (!f32_widths_ok({c0, c1, c2, c3}) || !acts_ok({act0, act1, act2}) || B < 0 || S < 1 ||
      HW < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (B == 0) return cudaSuccess;
  EmbedF32 a{};
  a.x = static_cast<const float*>(x);
  const void* w[3] = {w0, w1, w2};
  const void* bb[3] = {b0, b1, b2};
  for (int i = 0; i < 3; ++i) {
    a.w[i] = static_cast<const float*>(w[i]);
    a.b[i] = static_cast<const float*>(bb[i]);
  }
  a.e = static_cast<float*>(e);
  a.mean = static_cast<float*>(mean);
  a.B = B, a.S = S, a.HW = HW;
  a.c[0] = c0, a.c[1] = c1, a.c[2] = c2, a.c[3] = c3;
  a.act[0] = act0, a.act[1] = act1, a.act[2] = act2;
  return launch_f32(pathnet_embed_f32_kernel, a, embed_f32_smem(a.c), n_blocks, device,
                    static_cast<cudaStream_t>(stream));
}

// K4-bwd in f32: x as the forward's; ge (B, S, HW, c3) and gmean (B, HW, c3)
// f32 or null (zero); w_i, b_i as the forward's and wt_i their transposes
// (c_{i+1}, c_i); dx (B, S, HW, c0) f32 or null (not computed).  parts:
// n_blocks partials of dW0 | dW1 | dW2 | db0 | db1 | db2 (scratch); out
// their sum in block order, f32.
extern "C" int wcmc_pathnet_embed_bwd_f32(const void* x, const void* ge, const void* gmean,
                                          const void* w0, const void* b0, const void* w1,
                                          const void* b1, const void* w2, const void* b2,
                                          const void* w0t, const void* w1t, const void* w2t,
                                          void* dx, void* parts, void* out, int B, int S, int HW,
                                          int c0, int c1, int c2, int c3, int act0, int act1,
                                          int act2, int n_blocks, int device, void* stream) {
  if (!f32_widths_ok({c0, c1, c2, c3}) || !acts_ok({act0, act1, act2}) || B < 1 || S < 1 ||
      HW < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  EmbedF32 a{};
  a.x = static_cast<const float*>(x);
  a.ge = static_cast<const float*>(ge);
  a.gm = static_cast<const float*>(gmean);
  const void* w[3] = {w0, w1, w2};
  const void* bb[3] = {b0, b1, b2};
  const void* wt[3] = {w0t, w1t, w2t};
  for (int i = 0; i < 3; ++i) {
    a.w[i] = static_cast<const float*>(w[i]);
    a.b[i] = static_cast<const float*>(bb[i]);
    a.wt[i] = static_cast<const float*>(wt[i]);
  }
  a.dx = static_cast<float*>(dx);
  a.parts = static_cast<float*>(parts);
  a.B = B, a.S = S, a.HW = HW;
  a.c[0] = c0, a.c[1] = c1, a.c[2] = c2, a.c[3] = c3;
  a.act[0] = act0, a.act[1] = act1, a.act[2] = act2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_f32(pathnet_embed_bwd_f32_kernel, a, embed_f32_smem(a.c), n_blocks,
                               device, s);
  if (err != cudaSuccess) return err;
  return reduce_parts(a.parts, static_cast<float*>(out), n_blocks, embed_f32_parts(a.c), s);
}

// K5-fwd in f32: e (B, S, HW, ce) f32; ctx (B, HW, cc) f32; w1 (ce + cc,
// c1), b1, w2 (c1, cout), b2 f32; out (B, S, HW, cout), or (B, S, cout,
// HW) with cmajor, f32 or bf16 (out_bf16); ssum and ssq (B, HW, cout) f32,
// both or neither null (the moments); all contiguous; widths 1 to 256.
extern "C" int wcmc_pathnet_head_f32(const void* e, const void* ctx, const void* w1,
                                     const void* b1, const void* w2, const void* b2, void* out,
                                     void* ssum, void* ssq, int B, int S, int HW, int ce, int cc,
                                     int c1, int cout, int act1, int act2, int out_bf16,
                                     int cmajor, int n_blocks, int device, void* stream) {
  if (!f32_widths_ok({ce, cc, c1, cout}) || !acts_ok({act1, act2}) || B < 0 || S < 1 ||
      HW < 1 || n_blocks < 1 || (ssum == nullptr) != (ssq == nullptr))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (B == 0) return cudaSuccess;
  HeadF32 a{};
  a.e = static_cast<const float*>(e);
  a.ctx = static_cast<const float*>(ctx);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.out = out;
  a.ssum = static_cast<float*>(ssum);
  a.ssq = static_cast<float*>(ssq);
  a.B = B, a.S = S, a.HW = HW, a.ce = ce, a.cc = cc, a.c1 = c1, a.cout = cout;
  a.act1 = act1, a.act2 = act2, a.out_bf16 = out_bf16, a.cmajor = cmajor;
  return launch_f32(pathnet_head_f32_kernel, a,
                    head_f32_smem(ce, cc, c1, cout, ssum != nullptr, 0), n_blocks, device,
                    static_cast<cudaStream_t>(stream));
}

// K5-bwd in f32: e, ctx, w1, b1, w2, b2 as the forward's; g the output's
// cotangent in the output's layout (channel-major with cmajor), gsum and
// gsq (B, HW, cout), each f32 or null (zero); w1et (c1, ce), w1ct (c1, cc)
// and w2t (cout, c1) the transposes; de (B, S, HW, ce) and dctx (B, HW, cc)
// f32.  parts: n_blocks partials of dW1 ((ce + cc) x c1) | dW2 | db1 | db2
// (scratch); out their sum in block order, f32.
extern "C" int wcmc_pathnet_head_bwd_f32(const void* e, const void* ctx, const void* g,
                                         const void* gsum, const void* gsq, const void* w1,
                                         const void* b1, const void* w2, const void* b2,
                                         const void* w1et, const void* w1ct, const void* w2t,
                                         void* de, void* dctx, void* parts, void* out, int B,
                                         int S, int HW, int ce, int cc, int c1, int cout,
                                         int act1, int act2, int cmajor, int n_blocks,
                                         int device, void* stream) {
  if (!f32_widths_ok({ce, cc, c1, cout}) || !acts_ok({act1, act2}) || B < 1 || S < 1 ||
      HW < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  HeadF32 a{};
  a.e = static_cast<const float*>(e);
  a.ctx = static_cast<const float*>(ctx);
  a.g = static_cast<const float*>(g);
  a.gsum = static_cast<const float*>(gsum);
  a.gsq = static_cast<const float*>(gsq);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.w1et = static_cast<const float*>(w1et);
  a.w1ct = static_cast<const float*>(w1ct);
  a.w2t = static_cast<const float*>(w2t);
  a.de = static_cast<float*>(de);
  a.dctx = static_cast<float*>(dctx);
  a.parts = static_cast<float*>(parts);
  a.B = B, a.S = S, a.HW = HW, a.ce = ce, a.cc = cc, a.c1 = c1, a.cout = cout;
  a.act1 = act1, a.act2 = act2, a.cmajor = cmajor;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_f32(pathnet_head_bwd_f32_kernel, a,
                               head_f32_smem(ce, cc, c1, cout, 0, 1), n_blocks, device, s);
  if (err != cudaSuccess) return err;
  return reduce_parts(a.parts, static_cast<float*>(out), n_blocks,
                      head_f32_parts(ce, cc, c1, cout), s);
}
