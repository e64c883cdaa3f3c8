// Fused per-particle update and row rebuild, one thread per lane; one entry
// point per dimension (update_rows_cuda, update_rows2d_cuda).
//
// Replaces: wgsparkl_tpu/ops/update_rows.py `_update_kernel` (launched by
// `update_rows`, dim=3 and dim=2), whose body is
// wgsparkl_tpu/ops/particle_update.py `particle_update_channels` /
// `particle_update_channels_2d`: rigid contact velocity, contact projection,
// velocity clamp, advection, penalty, F update, fracture check, Drucker-Prager
// return map, corotated or neo-Hookean stress (`elastic_model`, the integer
// argument `model`), APIC affine, and the rebuild of the next [48, NPAD] (3D)
// or [32, NPAD] (2D) row matrix.
// Bound on the H100, counted: device memory.  Per lane 3D reads 27 of the
// 48 input rows (0-2, 6, 21-39, 44-47), the sorted id, 12 G2P rows and 6
// particle-CDF rows, and writes 48 rows (~0.39 GB per substep at 1M lanes,
// ~0.12 ms), against one 8-sweep 3x3 Jacobi SVD (~1.5k flops) plus
// exp/log/sin.  What holds 3D in practice is the SVD's serial chain: 24
// Givens rotations of two IEEE divisions and two IEEE square roots each.
// 2D reads 19 of the 32 input rows (0, 1, 4, 13-23, 27-31), the sorted id,
// 6 G2P rows and 5 particle-CDF rows, and writes 32 rows (~0.1 GB at 490k
// lanes), against three closed-form 2x2 SVDs (~60 flops each) plus
// exp/log/sin.  The neo-Hookean stress replaces the stress SVD by a
// determinant and one logf.
// Design: scalar per-thread code that follows the plain version operation
// by operation (the translation unit is built with -fmad=false and IEEE
// division / sqrt), so kernel and plain version differ only where libm does
// (expf, logf, sinf).  Every read and write of a channel row is coalesced
// across the warp.  The 3D entry computes what the plain version computes
// three times once: one SVD of the updated F serves the fracture check (its
// |sigma| are the plain version's eig33_sigma values in another order, and
// the test does not depend on order), the Drucker-Prager return map and the
// corotated stress; a second SVD runs only on lanes whose F the return map
// replaced, and none on neo-Hookean lanes with plasticity disabled and no
// fracture check, where no output reads it.
// The material table is [16, mstride]: 128 lanes on the pallas path, a
// multiple of 128 sized from the material count on the dense and blocked
// transfers (one material a particle is allowed there); the constant of
// row r for material id m is mtable[r * mstride + m].
#include <cuda_runtime.h>
#include <stdint.h>

#define PCHAN 48
#define R_MID 22
#define R_DPS0 24
#define R_PHASE 27
#define R_F0 28
#define R_RV0 41
#define DEFAULT_FRICTION 20.0f
#define PENALTY_COEFF 1.0e3f
#define NEO_HOOKEAN 1       // the model argument: 0 corotated, 1 neo-Hookean

struct F3 { float m[3][3]; };

__device__ __forceinline__ float sgnf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// Trig-free Givens (c, s) zeroing the (p, q) entry of a symmetric 2x2.
__device__ __forceinline__ void givens(float app, float aqq, float apq,
                                       float* c, float* s) {
  bool nonzero = fabsf(apq) > 1e-30f;
  float safe = nonzero ? apq : 1.0f;
  float tau = (app - aqq) / (2.0f * safe);
  float t = sgnf(tau) / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  t = nonzero ? t : 0.0f;
  *c = 1.0f / sqrtf(1.0f + t * t);
  *s = t * *c;
}

// sym[0..5] = (00, 01, 02, 11, 12, 22); v row-major 3x3 (may be null).
__device__ __forceinline__ int skey(int i, int j) {
  if (i > j) { int t = i; i = j; j = t; }
  return i == 0 ? j : (i == 1 ? 2 + j : 5);
}

// Inlined at every call, so that p and q fold and sym stays in registers.
__device__ __forceinline__ void jacobi_rot(float* sym, float (*v)[3], int p, int q) {
  int r = 3 - p - q;
  float app = sym[skey(p, p)], aqq = sym[skey(q, q)], apq = sym[skey(p, q)];
  float c, s;
  givens(app, aqq, apq, &c, &s);
  float c2 = c * c, s2 = s * s, cs = c * s;
  float apr = sym[skey(p, r)], aqr = sym[skey(q, r)];
  sym[skey(p, p)] = c2 * app + 2.0f * cs * apq + s2 * aqq;
  sym[skey(q, q)] = s2 * app - 2.0f * cs * apq + c2 * aqq;
  sym[skey(p, q)] = 0.0f;
  sym[skey(p, r)] = c * apr + s * aqr;
  sym[skey(q, r)] = -s * apr + c * aqr;
  if (v) {
    for (int i = 0; i < 3; ++i) {
      float vip = v[i][p], viq = v[i][q];
      v[i][p] = c * vip + s * viq;
      v[i][q] = -s * vip + c * viq;
    }
  }
}

__device__ void sym_ftf(const F3& f, float* sym) {
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      float acc = f.m[0][i] * f.m[0][j];
      acc = acc + f.m[1][i] * f.m[1][j];
      acc = acc + f.m[2][i] * f.m[2][j];
      sym[skey(i, j)] = acc;
    }
}

__device__ float det3(const F3& f) {
  const float(*a)[3] = f.m;
  return a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
       - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
       + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]);
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}

// Signed SVD of f, whose determinant is det: uc[k][i] = U[i][k],
// vc[k][i] = V[i][k]; sig sorted by decreasing value, sig[2] carrying
// sign(det).
__device__ __forceinline__ void svd3(const F3& f, float det, float uc[3][3], float* sig,
                                     float vc[3][3]) {
  float sym[6];
  sym_ftf(f, sym);
  float v[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
  for (int s = 0; s < 8; ++s) {
    jacobi_rot(sym, v, 0, 1);
    jacobi_rot(sym, v, 0, 2);
    jacobi_rot(sym, v, 1, 2);
  }
  float lam[3] = {sym[0], sym[3], sym[5]};
  float col[3][3];
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < 3; ++i) col[k][i] = v[i][k];
  const int pa[3] = {0, 0, 1}, pb[3] = {1, 2, 2};
  for (int t = 0; t < 3; ++t) {
    int a = pa[t], b = pb[t];
    if (lam[a] < lam[b]) {
      float tl = lam[a]; lam[a] = lam[b]; lam[b] = tl;
      for (int i = 0; i < 3; ++i) {
        float tc = col[a][i]; col[a][i] = col[b][i]; col[b][i] = tc;
      }
    }
  }
  for (int k = 0; k < 2; ++k)
    for (int i = 0; i < 3; ++i) vc[k][i] = col[k][i];
  vc[2][0] = vc[0][1] * vc[1][2] - vc[0][2] * vc[1][1];
  vc[2][1] = vc[0][2] * vc[1][0] - vc[0][0] * vc[1][2];
  vc[2][2] = vc[0][0] * vc[1][1] - vc[0][1] * vc[1][0];
  for (int k = 0; k < 3; ++k) sig[k] = sqrtf(fmaxf(lam[k], 0.0f));
  float fv0[3], fv1[3];
  for (int i = 0; i < 3; ++i) {
    float a0 = f.m[i][0] * vc[0][0];
    a0 = a0 + f.m[i][1] * vc[0][1];
    a0 = a0 + f.m[i][2] * vc[0][2];
    fv0[i] = a0;
    float a1 = f.m[i][0] * vc[1][0];
    a1 = a1 + f.m[i][1] * vc[1][1];
    a1 = a1 + f.m[i][2] * vc[1][2];
    fv1[i] = a1;
  }
  float u0[3], u1[3];
  {
    float n = norm3(fv0[0], fv0[1], fv0[2]);
    bool ok = n > 1e-12f;
    float inv = ok ? 1.0f / n : 0.0f;
    const float fb[3] = {1.f, 0.f, 0.f};
    for (int i = 0; i < 3; ++i) u0[i] = ok ? fv0[i] * inv : fb[i];
  }
  float d01 = fv1[0] * u0[0] + fv1[1] * u0[1] + fv1[2] * u0[2];
  float u1r[3];
  for (int i = 0; i < 3; ++i) u1r[i] = fv1[i] - d01 * u0[i];
  bool use_a = fabsf(u0[0]) < 0.9f;
  float alt[3];
  if (use_a) { alt[0] = 0.f; alt[1] = -u0[2]; alt[2] = u0[1]; }
  else { alt[0] = u0[2]; alt[1] = 0.f; alt[2] = -u0[0]; }
  float nalt = fmaxf(norm3(alt[0], alt[1], alt[2]), 1e-30f);
  for (int i = 0; i < 3; ++i) alt[i] = alt[i] / nalt;
  {
    float n = norm3(u1r[0], u1r[1], u1r[2]);
    bool ok = n > 1e-12f;
    float inv = ok ? 1.0f / n : 0.0f;
    for (int i = 0; i < 3; ++i) u1[i] = ok ? u1r[i] * inv : alt[i];
  }
  for (int i = 0; i < 3; ++i) { uc[0][i] = u0[i]; uc[1][i] = u1[i]; }
  uc[2][0] = u0[1] * u1[2] - u0[2] * u1[1];
  uc[2][1] = u0[2] * u1[0] - u0[0] * u1[2];
  uc[2][2] = u0[0] * u1[1] - u0[1] * u1[0];
  sig[2] = sig[2] * (det < 0.f ? -1.0f : 1.0f);
}

// UPDATE_THREADS a block, four blocks an SM: the register cap of 64 costs
// ~170 bytes of spills a lane and still beats the 102 registers the kernel
// takes uncapped (16 warps an SM against 32; the SVD's serial chain of
// divisions and square roots wants warps to hide its latency; PERF.md).
#define UPDATE_THREADS 256
__global__ void __launch_bounds__(UPDATE_THREADS, 4) update_kernel(
    const float* __restrict__ rows, const float* __restrict__ krows,
    const float* __restrict__ pcdf, const int* __restrict__ sids,
    const int* __restrict__ ce, const float* __restrict__ btable,
    const float* __restrict__ mtable, long long npad, long long kstride,
    long long pstride, long long mstride, int nc, int n_mat, int live_below,
    int model, int centered,
    float dt, float h, float invd, float limit, float pen_thresh, float corr_min,
    float* __restrict__ out) {
  long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= npad) return;
  auto row = [&](int r) { return rows[(long long)r * npad + l]; };
  auto put = [&](int r, float x) { out[(long long)r * npad + l] = x; };
  bool ig = sids[l] < live_below && l < (long long)ce[0];

  float pos[3], v[3];
  for (int k = 0; k < 3; ++k) {
    pos[k] = row(k);
    v[k] = ig ? krows[k * kstride + l] : 0.0f;
  }
  float grad[3][3];
  F3 f;
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      grad[i][k] = ig ? invd * (krows[(3 + 3 * i + k) * kstride + l]
                                - (centered ? 0.0f : v[i] * pos[k]))
                      : 0.0f;
      f.m[i][k] = row(R_F0 + 3 * i + k);
    }
  float aff_lo = ig ? pcdf[l] : 0.0f;
  float aff_hi = ig ? pcdf[5 * pstride + l] : 0.0f;
  uint32_t aff = (uint32_t)aff_lo | ((uint32_t)aff_hi << 16);
  float sd = ig ? pcdf[pstride + l] : 0.0f;
  float nrm[3];
  for (int k = 0; k < 3; ++k) nrm[k] = ig ? pcdf[(2 + k) * pstride + l] : 0.0f;

  float rv[3] = {0.f, 0.f, 0.f};
  for (int b = 0; b < nc; ++b) {
    bool has = (aff >> b) & 1u;
    const float* bt = btable;
    float rel[3];
    for (int k = 0; k < 3; ++k) rel[k] = pos[k] - bt[k * 128 + b];
    float lin0 = bt[3 * 128 + b], lin1 = bt[4 * 128 + b], lin2 = bt[5 * 128 + b];
    float a0 = bt[6 * 128 + b], a1 = bt[7 * 128 + b], a2 = bt[8 * 128 + b];
    float bvb[3] = {lin0 + a1 * rel[2] - a2 * rel[1],
                    lin1 + a2 * rel[0] - a0 * rel[2],
                    lin2 + a0 * rel[1] - a1 * rel[0]};
    for (int k = 0; k < 3; ++k) rv[k] = rv[k] + (has ? bvb[k] : 0.0f);
  }
  int mid = (int)row(R_MID);
  mid = mid < 0 ? 0 : (mid > n_mat - 1 ? n_mat - 1 : mid);
  auto mval = [&](int r) { return mtable[r * mstride + mid]; };
  float mass = row(6);

  // Contact projection, clamp, advection, penalty.
  bool penetrating = sd < pen_thresh;
  float rel[3];
  for (int i = 0; i < 3; ++i) rel[i] = v[i] - rv[i];
  float nv = rel[0] * nrm[0] + rel[1] * nrm[1] + rel[2] * nrm[2];
  float tang[3];
  for (int i = 0; i < 3; ++i) tang[i] = rel[i] - nrm[i] * nv;
  float tl = sqrtf(tang[0] * tang[0] + tang[1] * tang[1] + tang[2] * tang[2]);
  float inv_tl = tl > 1e-8f ? 1.0f / fmaxf(tl, 1e-30f) : 0.0f;
  float scale = fmaxf(tl + DEFAULT_FRICTION * nv, 0.0f) * inv_tl;
  float nvel[3];
  for (int i = 0; i < 3; ++i) {
    float proj = nv < 0.0f ? tang[i] * scale : rel[i];
    nvel[i] = penetrating ? rv[i] + proj : v[i];
  }
  float speed = sqrtf(nvel[0] * nvel[0] + nvel[1] * nvel[1] + nvel[2] * nvel[2]);
  float cl = speed > limit ? limit / fmaxf(speed, 1e-30f) : 1.0f;
  float npos[3];
  for (int i = 0; i < 3; ++i) {
    nvel[i] = nvel[i] * cl;
    npos[i] = pos[i] + nvel[i] * dt;
  }
  float corrected = fmaxf(sd, corr_min);
  float pen = dt * -corrected * PENALTY_COEFF;
  for (int i = 0; i < 3; ++i)
    nvel[i] = penetrating ? nvel[i] + pen * nrm[i] : nvel[i];

  // F += dt grad F.
  F3 nf;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = grad[i][0] * f.m[0][j];
      acc = acc + grad[i][1] * f.m[1][j];
      acc = acc + grad[i][2] * f.m[2][j];
      nf.m[i][j] = f.m[i][j] + dt * acc;
    }

  // One SVD of the updated F serves the fracture check, Drucker-Prager and
  // the corotated stress; a neo-Hookean lane with neither of the first two
  // needs none.
  float phase = row(R_PHASE), stretch = mval(8);
  bool check = phase > 0.0f && stretch > 0.0f;
  float dp_lam = mval(6), dp_mu = mval(7);
  bool enabled = dp_lam > 0.0f;
  const float detf = det3(nf);
  float uc[3][3], sig[3], vc[3][3];
  if (check || enabled || model != NEO_HOOKEAN) svd3(nf, detf, uc, sig, vc);

  // Fracture check on |sigma|, the values the plain version's eig33_sigma
  // gives in another order (the same sweeps of the same F^T F): sign(det F)
  // goes to every value equal to the least.
  float new_phase = phase;
  if (check) {
    float sg[3];
    for (int k = 0; k < 3; ++k) sg[k] = fabsf(sig[k]);
    float smin = fminf(fminf(sg[0], sg[1]), sg[2]);
    float sgn = detf < 0.0f ? -1.0f : 1.0f;
    bool over = false;
    for (int k = 0; k < 3; ++k)
      over = over || (sg[k] * (sg[k] == smin ? sgn : 1.0f) > stretch);
    new_phase = over ? 0.0f : phase;
  }

  // Drucker-Prager (disabled at lambda <= 0: F and the state stay).
  float dps[3] = {row(R_DPS0), row(R_DPS0 + 1), row(R_DPS0 + 2)};
  float ndps[3] = {dps[0], dps[1], dps[2]};
  bool projected = false;
  if (enabled) {
    float h0 = mval(2), h1 = mval(3), h2 = mval(4), h3 = mval(5);
    const float df = 3.0f;
    float angle = h0 + (h1 * dps[1] - h3) * expf(-h2 * dps[1]);
    float s = sinf(angle);
    float alpha = 0.8164966106414795f * (2.0f * s) / (3.0f - s);
    float strain[3];
    for (int k = 0; k < 3; ++k)
      strain[k] = logf(fmaxf(sig[k], 1e-12f)) + dps[2] / df;
    float trace = strain[0] + strain[1] + strain[2];
    float dev[3];
    for (int k = 0; k < 3; ++k) dev[k] = strain[k] - trace / df;
    float dev_norm = sqrtf(dev[0] * dev[0] + dev[1] * dev[1] + dev[2] * dev[2]);
    bool case_a = trace > 0.0f || dev_norm == 0.0f;
    float hard_a = sqrtf(strain[0] * strain[0] + strain[1] * strain[1]
                         + strain[2] * strain[2]);
    float gamma = dev_norm + (df * dp_lam + 2.0f * dp_mu) / (2.0f * dp_mu) * trace * alpha;
    bool case_b = !case_a && gamma <= 0.0f;
    float sc = gamma / fmaxf(dev_norm, 1e-20f);
    float nsig[3];
    for (int k = 0; k < 3; ++k)
      nsig[k] = case_a ? 1.0f : expf(strain[k] - dev[k] * sc);
    float plastic_h = case_a ? hard_a : gamma;
    float prev_det = sig[0] * sig[1] * sig[2];
    float new_det = nsig[0] * nsig[1] * nsig[2];
    projected = !case_b && new_phase == 0.0f;
    if (projected) {
      ndps[0] = dps[0] * prev_det / (new_det != 0.0f ? new_det : 1.0f);
      ndps[1] = dps[1] + plastic_h;
      ndps[2] = dps[2] + logf(fmaxf(prev_det, 1e-20f)) - logf(fmaxf(new_det, 1e-20f));
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          float p = uc[0][i] * nsig[0] * vc[0][j];
          p = p + uc[1][i] * nsig[1] * vc[1][j];
          p = p + uc[2][i] * nsig[2] * vc[2][j];
          nf.m[i][j] = p;
        }
    }
  }

  // Kirchhoff stress (corotated or neo-Hookean) and APIC affine.
  float aff_out[3][3];
  if (model == NEO_HOOKEAN) {
    float lam = mval(0), mu = mval(1), vol0 = mval(9);
    float diag = lam * logf(fmaxf(det3(nf), 1e-10f)) - mu;
    float scale_a = vol0 * invd * dt;
    for (int i = 0; i < 3; ++i)
      for (int jj = 0; jj < 3; ++jj) {
        float fft = nf.m[i][0] * nf.m[jj][0];
        fft = fft + nf.m[i][1] * nf.m[jj][1];
        fft = fft + nf.m[i][2] * nf.m[jj][2];
        float stress = i == jj ? mu * fft + diag : mu * fft;
        aff_out[i][jj] = grad[i][jj] * mass - stress * scale_a;
      }
  } else {
    float lam = mval(0), mu = mval(1), vol0 = mval(9);
    // The SVD above, unless Drucker-Prager replaced F.
    if (projected) svd3(nf, det3(nf), uc, sig, vc);
    float j = sig[0] * sig[1] * sig[2];
    float diag = lam * (j - 1.0f) * j;
    float two_mu = 2.0f * mu;
    float scale_a = vol0 * invd * dt;
    for (int i = 0; i < 3; ++i)
      for (int jj = 0; jj < 3; ++jj) {
        float acc = 0.0f;
        for (int k = 0; k < 3; ++k) {
          float sh = uc[0][i] * (sig[0] - 1.0f) * vc[0][k];
          sh = sh + uc[1][i] * (sig[1] - 1.0f) * vc[1][k];
          sh = sh + uc[2][i] * (sig[2] - 1.0f) * vc[2][k];
          float term = sh * nf.m[jj][k];
          acc = k == 0 ? term : acc + term;
        }
        float stress = i == jj ? two_mu * acc + diag : two_mu * acc;
        aff_out[i][jj] = grad[i][jj] * mass - stress * scale_a;
      }
  }

  for (int k = 0; k < 3; ++k) { put(k, npos[k]); put(3 + k, nvel[k]); }
  put(6, mass);
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) put(7 + 3 * i + k, aff_out[i][k]);
  put(16, aff_lo);
  for (int k = 0; k < 3; ++k) put(17 + k, nrm[k]);
  put(20, aff_hi);
  for (int r = 21; r < 24; ++r) put(r, row(r));
  for (int k = 0; k < 3; ++k) put(R_DPS0 + k, ndps[k]);
  put(R_PHASE, new_phase);
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) put(R_F0 + 3 * i + k, nf.m[i][k]);
  for (int r = R_F0 + 9; r < 40; ++r) put(r, row(r));
  put(40, sd);
  for (int k = 0; k < 3; ++k) put(R_RV0 + k, rv[k]);
  for (int r = R_RV0 + 3; r < PCHAN; ++r) put(r, row(r));
}

// ------------------------------------------------------------------ 2D
// Rows of the 2D matrix (ops/rows2d.py).
#define R2_PCHAN 32
#define R2_MID 14
#define R2_DPS0 16
#define R2_PHASE 19
#define R2_F0 20
#define R2_RV0 25

// Signed 2x2 SVD (math/svd.py svd2x2_ch): polar rotation in closed form,
// one Givens rotation of the symmetric factor.  uc[k][i] = U[i][k],
// vc[k][i] = V[i][k]; sig[1] carries sign(det F).
__device__ void svd2(const float f[2][2], float uc[2][2], float sig[2],
                     float vc[2][2]) {
  float a = f[0][0], b = f[0][1], c = f[1][0], d = f[1][1];
  float det = a * d - b * c;
  float sgn = det < 0.0f ? -1.0f : 1.0f;
  float b01 = b * sgn, b11 = d * sgn;
  float x = a + b11;
  float y = c - b01;
  float h2 = x * x + y * y;
  bool ok = h2 > 1e-30f;
  float inv_h = ok ? 1.0f / sqrtf(fmaxf(h2, 1e-30f)) : 0.0f;
  float cr = ok ? x * inv_h : 1.0f;
  float sr = y * inv_h;
  float p00 = cr * a + sr * c;
  float p01 = cr * b01 + sr * b11;
  float p11 = -sr * b01 + cr * b11;
  float cv, sv;
  givens(p00, p11, p01, &cv, &sv);
  float l0 = cv * cv * p00 + 2.0f * cv * sv * p01 + sv * sv * p11;
  float l1 = sv * sv * p00 - 2.0f * cv * sv * p01 + cv * cv * p11;
  bool swap = l0 < l1;
  float cs = swap ? -sv : cv, ss = swap ? cv : sv;
  float cu = cr * cs - sr * ss;
  float su = sr * cs + cr * ss;
  uc[0][0] = cu; uc[0][1] = su;
  uc[1][0] = -su; uc[1][1] = cu;
  vc[0][0] = cs; vc[0][1] = ss * sgn;
  vc[1][0] = -ss * sgn; vc[1][1] = cs;
  sig[0] = swap ? l1 : l0;
  sig[1] = (swap ? l0 : l1) * sgn;
}

__global__ void update2d_kernel(
    const float* __restrict__ rows, const float* __restrict__ krows,
    const float* __restrict__ pcdf, const int* __restrict__ sids,
    const int* __restrict__ ce, const float* __restrict__ btable,
    const float* __restrict__ mtable, long long npad, long long kstride,
    long long pstride, long long mstride, int nc, int n_mat, int live_below,
    int model, int centered,
    float dt, float h, float invd, float limit, float pen_thresh, float corr_min,
    float* __restrict__ out) {
  long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= npad) return;
  auto row = [&](int r) { return rows[(long long)r * npad + l]; };
  auto put = [&](int r, float x) { out[(long long)r * npad + l] = x; };
  bool ig = sids[l] < live_below && l < (long long)ce[0];

  float pos[2], v[2];
  for (int k = 0; k < 2; ++k) {
    pos[k] = row(k);
    v[k] = ig ? krows[k * kstride + l] : 0.0f;
  }
  float grad[2][2], f[2][2];
  for (int i = 0; i < 2; ++i)
    for (int k = 0; k < 2; ++k) {
      grad[i][k] = ig ? invd * (krows[(2 + 2 * i + k) * kstride + l]
                                - (centered ? 0.0f : v[i] * pos[k]))
                      : 0.0f;
      f[i][k] = row(R2_F0 + 2 * i + k);
    }
  float aff_lo = ig ? pcdf[l] : 0.0f;
  float aff_hi = ig ? pcdf[4 * pstride + l] : 0.0f;
  uint32_t aff = (uint32_t)aff_lo | ((uint32_t)aff_hi << 16);
  float sd = ig ? pcdf[pstride + l] : 0.0f;
  float nrm[2];
  for (int k = 0; k < 2; ++k) nrm[k] = ig ? pcdf[(2 + k) * pstride + l] : 0.0f;

  // Rigid contact velocity: 2D body table rows 0-1 COM, 2-3 linvel, 4 angvel.
  float rv[2] = {0.f, 0.f};
  for (int b = 0; b < nc; ++b) {
    bool has = (aff >> b) & 1u;
    float rel0 = pos[0] - btable[b], rel1 = pos[1] - btable[128 + b];
    float ang = btable[4 * 128 + b];
    float bvb[2] = {btable[2 * 128 + b] - ang * rel1, btable[3 * 128 + b] + ang * rel0};
    for (int k = 0; k < 2; ++k) rv[k] = rv[k] + (has ? bvb[k] : 0.0f);
  }
  int mid = (int)row(R2_MID);
  mid = mid < 0 ? 0 : (mid > n_mat - 1 ? n_mat - 1 : mid);
  auto mval = [&](int r) { return mtable[r * mstride + mid]; };
  float mass = row(4);

  // Contact projection, clamp, advection, penalty.
  bool penetrating = sd < pen_thresh;
  float rel[2] = {v[0] - rv[0], v[1] - rv[1]};
  float nv = rel[0] * nrm[0] + rel[1] * nrm[1];
  float tang[2] = {rel[0] - nrm[0] * nv, rel[1] - nrm[1] * nv};
  float tl = sqrtf(tang[0] * tang[0] + tang[1] * tang[1]);
  float inv_tl = tl > 1e-8f ? 1.0f / fmaxf(tl, 1e-30f) : 0.0f;
  float scale = fmaxf(tl + DEFAULT_FRICTION * nv, 0.0f) * inv_tl;
  float nvel[2];
  for (int i = 0; i < 2; ++i) {
    float proj = nv < 0.0f ? tang[i] * scale : rel[i];
    nvel[i] = penetrating ? rv[i] + proj : v[i];
  }
  float speed = sqrtf(nvel[0] * nvel[0] + nvel[1] * nvel[1]);
  float cl = speed > limit ? limit / fmaxf(speed, 1e-30f) : 1.0f;
  float npos[2];
  for (int i = 0; i < 2; ++i) {
    nvel[i] = nvel[i] * cl;
    npos[i] = pos[i] + nvel[i] * dt;
  }
  float corrected = fmaxf(sd, corr_min);
  float pen = dt * -corrected * PENALTY_COEFF;
  for (int i = 0; i < 2; ++i)
    nvel[i] = penetrating ? nvel[i] + pen * nrm[i] : nvel[i];

  // F += dt grad F.
  float nf[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      float acc = grad[i][0] * f[0][j];
      acc = acc + grad[i][1] * f[1][j];
      nf[i][j] = f[i][j] + dt * acc;
    }

  // Fracture check on the signed singular values.
  float uc[2][2], sig[2], vc[2][2];
  svd2(nf, uc, sig, vc);
  float phase = row(R2_PHASE), stretch = mval(8);
  bool check = phase > 0.0f && stretch > 0.0f;
  bool over = sig[0] > stretch || sig[1] > stretch;
  float new_phase = (check && over) ? 0.0f : phase;

  // Drucker-Prager (the same SVD of the updated F).
  float dps[3] = {row(R2_DPS0), row(R2_DPS0 + 1), row(R2_DPS0 + 2)};
  float ndps[3] = {dps[0], dps[1], dps[2]};
  {
    float h0 = mval(2), h1 = mval(3), h2 = mval(4), h3 = mval(5);
    float lam = mval(6), mu = mval(7);
    bool enabled = lam > 0.0f;
    const float df = 2.0f;
    float angle = h0 + (h1 * dps[1] - h3) * expf(-h2 * dps[1]);
    float s = sinf(angle);
    float alpha = 0.8164966106414795f * (2.0f * s) / (3.0f - s);
    float strain[2];
    for (int k = 0; k < 2; ++k)
      strain[k] = logf(fmaxf(sig[k], 1e-12f)) + dps[2] / df;
    float trace = strain[0] + strain[1];
    float dev[2];
    for (int k = 0; k < 2; ++k) dev[k] = strain[k] - trace / df;
    float dev_norm = sqrtf(dev[0] * dev[0] + dev[1] * dev[1]);
    bool case_a = trace > 0.0f || dev_norm == 0.0f;
    float hard_a = sqrtf(strain[0] * strain[0] + strain[1] * strain[1]);
    float gamma = dev_norm + (df * lam + 2.0f * mu) / (2.0f * mu) * trace * alpha;
    bool case_b = !case_a && gamma <= 0.0f;
    float sc = gamma / fmaxf(dev_norm, 1e-20f);
    float nsig[2];
    for (int k = 0; k < 2; ++k)
      nsig[k] = case_a ? 1.0f : expf(strain[k] - dev[k] * sc);
    float plastic_h = case_a ? hard_a : gamma;
    float prev_det = sig[0] * sig[1];
    float new_det = nsig[0] * nsig[1];
    bool apply = enabled && !case_b;
    bool granular = new_phase == 0.0f;
    if (apply && granular) {
      ndps[0] = dps[0] * prev_det / (new_det != 0.0f ? new_det : 1.0f);
      ndps[1] = dps[1] + plastic_h;
      ndps[2] = dps[2] + logf(fmaxf(prev_det, 1e-20f)) - logf(fmaxf(new_det, 1e-20f));
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) {
          float p = uc[0][i] * nsig[0] * vc[0][j];
          p = p + uc[1][i] * nsig[1] * vc[1][j];
          nf[i][j] = p;
        }
    }
  }

  // Kirchhoff stress (corotated or neo-Hookean) and APIC affine.
  float aff_out[2][2];
  if (model == NEO_HOOKEAN) {
    float lam = mval(0), mu = mval(1), vol0 = mval(9);
    float det = nf[0][0] * nf[1][1] - nf[0][1] * nf[1][0];
    float diag = lam * logf(fmaxf(det, 1e-10f)) - mu;
    float scale_a = vol0 * invd * dt;
    for (int i = 0; i < 2; ++i)
      for (int jj = 0; jj < 2; ++jj) {
        float fft = nf[i][0] * nf[jj][0];
        fft = fft + nf[i][1] * nf[jj][1];
        float stress = i == jj ? mu * fft + diag : mu * fft;
        aff_out[i][jj] = grad[i][jj] * mass - stress * scale_a;
      }
  } else {
    float lam = mval(0), mu = mval(1), vol0 = mval(9);
    svd2(nf, uc, sig, vc);
    float j = sig[0] * sig[1];
    float diag = lam * (j - 1.0f) * j;
    float two_mu = 2.0f * mu;
    float scale_a = vol0 * invd * dt;
    for (int i = 0; i < 2; ++i)
      for (int jj = 0; jj < 2; ++jj) {
        float acc = 0.0f;
        for (int k = 0; k < 2; ++k) {
          float sh = uc[0][i] * (sig[0] - 1.0f) * vc[0][k];
          sh = sh + uc[1][i] * (sig[1] - 1.0f) * vc[1][k];
          float term = sh * nf[jj][k];
          acc = k == 0 ? term : acc + term;
        }
        float stress = i == jj ? two_mu * acc + diag : two_mu * acc;
        aff_out[i][jj] = grad[i][jj] * mass - stress * scale_a;
      }
  }

  for (int k = 0; k < 2; ++k) { put(k, npos[k]); put(2 + k, nvel[k]); }
  put(4, mass);
  for (int i = 0; i < 2; ++i)
    for (int k = 0; k < 2; ++k) put(5 + 2 * i + k, aff_out[i][k]);
  put(9, aff_lo);
  for (int k = 0; k < 2; ++k) put(10 + k, nrm[k]);
  put(12, aff_hi);
  for (int r = 13; r < 16; ++r) put(r, row(r));
  for (int k = 0; k < 3; ++k) put(R2_DPS0 + k, ndps[k]);
  put(R2_PHASE, new_phase);
  for (int i = 0; i < 2; ++i)
    for (int k = 0; k < 2; ++k) put(R2_F0 + 2 * i + k, nf[i][k]);
  put(24, sd);
  for (int k = 0; k < 2; ++k) put(R2_RV0 + k, rv[k]);
  for (int r = R2_RV0 + 2; r < R2_PCHAN; ++r) put(r, row(r));
}

extern "C" int update_rows2d_cuda(
    const float* rows, const float* krows, const float* pcdf, const int* sids,
    const int* ce, const float* btable, const float* mtable, long long npad,
    long long kstride, long long pstride, long long mstride, long long nc,
    long long n_mat,
    long long live_below, long long model, long long centered, float dt, float h,
    float invd,
    float limit, float pen_thresh, float corr_min, float* out,
    cudaStream_t stream) {
  unsigned blocks = (unsigned)((npad + 127) / 128);
  update2d_kernel<<<blocks, 128, 0, stream>>>(
      rows, krows, pcdf, sids, ce, btable, mtable, npad, kstride, pstride,
      mstride, (int)nc, (int)n_mat, (int)live_below, (int)model, (int)centered, dt, h, invd,
      limit,
      pen_thresh, corr_min, out);
  return (int)cudaGetLastError();
}

extern "C" int update_rows_cuda(
    const float* rows, const float* krows, const float* pcdf, const int* sids,
    const int* ce, const float* btable, const float* mtable, long long npad,
    long long kstride, long long pstride, long long mstride, long long nc,
    long long n_mat,
    long long live_below, long long model, long long centered, float dt, float h,
    float invd,
    float limit, float pen_thresh, float corr_min, float* out,
    cudaStream_t stream) {
  unsigned blocks = (unsigned)((npad + UPDATE_THREADS - 1) / UPDATE_THREADS);
  update_kernel<<<blocks, UPDATE_THREADS, 0, stream>>>(
      rows, krows, pcdf, sids, ce, btable, mtable, npad, kstride, pstride,
      mstride, (int)nc, (int)n_mat, (int)live_below, (int)model, (int)centered, dt, h, invd,
      limit,
      pen_thresh, corr_min, out);
  return (int)cudaGetLastError();
}
