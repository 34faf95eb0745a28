/* pdwt_cpu — native CPU reference engine for the JAX wavelet framework.
 *
 * Implements the exact transform index semantics of the JAX engines
 * (see pdwt_tpu/core/conv.py docstring; derived from the reference CUDA
 * kernels, src/separable.cu:91-328,409-626) with double
 * accumulation, as the high-accuracy native oracle + standalone CLI
 * backend.  The reference's native components (its CUDA library) get this
 * native CPU equivalent; the device path is the JAX/XLA engine.
 *
 * All functions return 0 on success, nonzero on argument errors.
 * Coefficient buffers are caller-allocated; sizes follow the decimation
 * rule n -> (n+1)/2 per level (odd sizes round up; reference:
 * /root/reference/src/utils.cu:23-27), or stay full-size for SWT.
 */
#ifndef PDWT_CPU_H
#define PDWT_CPU_H

/* Array element type: pdwt_real defaults to float; -DPDWT_DOUBLEPRECISION
 * builds the double-precision library (libpdwt_cpud.so), mirroring the
 * reference's dual build (reference: Makefile:36-39, src/filters.h:16-30).
 * Filter taps are always double. */
#ifdef PDWT_DOUBLEPRECISION
typedef double pdwt_real;
#else
typedef float pdwt_real;
#endif

#ifdef __cplusplus
extern "C" {
#endif

/* ---- single-level 1D primitives (batched over rows) ---- */

/* Decimated analysis: x (batch, n) row-major -> out_lo/out_hi
 * (batch, (n+1)/2).  Periodic boundary; odd n virtually extends by
 * repeating the last element. */
int pdwt_dwt1_level(const pdwt_real *x, int batch, int n,
                    const double *dec_lo, const double *dec_hi, int hlen,
                    pdwt_real *out_lo, pdwt_real *out_hi);

/* Decimated synthesis: lo/hi (batch, m) -> out (batch, out_len),
 * out_len in {2m-1, 2m}. */
int pdwt_idwt1_level(const pdwt_real *lo, const pdwt_real *hi, int batch, int m,
                     const double *rec_lo, const double *rec_hi, int hlen,
                     int out_len, pdwt_real *out);

/* A-trous analysis at `level` >= 1 (dilation 2^(level-1)), full size. */
int pdwt_swt1_level(const pdwt_real *x, int batch, int n,
                    const double *dec_lo, const double *dec_hi, int hlen,
                    int level, pdwt_real *out_lo, pdwt_real *out_hi);

/* A-trous synthesis (includes the 1/2 normalization per pass). */
int pdwt_iswt1_level(const pdwt_real *lo, const pdwt_real *hi, int batch, int n,
                     const double *rec_lo, const double *rec_hi, int hlen,
                     int level, pdwt_real *out);

/* ---- multi-level drivers ---- */

/* 2D forward: img (nr, nc) row-major.  coeffs is an array of
 * 3*levels + 1 caller-allocated pointers laid out [A_n, H1, V1, D1, ...,
 * Hn, Vn, Dn] (the reference buffer layout,
 * /root/reference/src/common.cu:400-445).  H = highpass along rows.
 * swt != 0 keeps full size per level. */
int pdwt_forward2d(const pdwt_real *img, int nr, int nc,
                   const double *dec_lo, const double *dec_hi, int hlen,
                   int levels, int swt, pdwt_real **coeffs);

int pdwt_inverse2d(pdwt_real *const *coeffs, int nr, int nc,
                   const double *rec_lo, const double *rec_hi, int hlen,
                   int levels, int swt, pdwt_real *img_out);

/* 1D forward, batched over rows: x (batch, n).  coeffs = levels + 1
 * pointers [A_n, D1, ..., Dn], each (batch, size_l). */
int pdwt_forward1d(const pdwt_real *x, int batch, int n,
                   const double *dec_lo, const double *dec_hi, int hlen,
                   int levels, int swt, pdwt_real **coeffs);

int pdwt_inverse1d(pdwt_real *const *coeffs, int batch, int n,
                   const double *rec_lo, const double *rec_hi, int hlen,
                   int levels, int swt, pdwt_real *out);

/* 3D forward: vol (nd, nr, nc) row-major (depth-major).  coeffs is an
 * array of 7*levels + 1 caller-allocated pointers [A_n, then per level
 * the 7 bands in channel order ch = 4*k_col + 2*k_row + k_dep
 * (daa, ada, dda, aad, dad, add, ddd)].  The reference has no 3D
 * ("3D is not handled at the moment", /root/reference/README.md). */
int pdwt_forward3d(const pdwt_real *vol, int nd, int nr, int nc,
                   const double *dec_lo, const double *dec_hi, int hlen,
                   int levels, int swt, pdwt_real **coeffs);

int pdwt_inverse3d(pdwt_real *const *coeffs, int nd, int nr, int nc,
                   const double *rec_lo, const double *rec_hi, int hlen,
                   int levels, int swt, pdwt_real *out);

/* ---- elementwise ops (in place) ---- */

void pdwt_soft_threshold(pdwt_real *x, long n, pdwt_real beta);
void pdwt_hard_threshold(pdwt_real *x, long n, pdwt_real beta);
/* non-negative garrote: x*max(1 - beta^2/x^2, 0) */
void pdwt_garrote_threshold(pdwt_real *x, long n, pdwt_real beta);
/* firm (semisoft): 0 below b1, identity above b2, linear ramp between */
void pdwt_firm_threshold(pdwt_real *x, long n, pdwt_real b1, pdwt_real b2);
void pdwt_proj_linf(pdwt_real *x, long n, pdwt_real beta);
double pdwt_norm1(const pdwt_real *x, long n);
double pdwt_norm2sq(const pdwt_real *x, long n);

/* Circular shift of a (nr, nc) image by (sr, sc); out != in. */
int pdwt_circshift2d(const pdwt_real *in, pdwt_real *out, int nr, int nc,
                     int sr, int sc);

/* ---- misc ---- */

int pdwt_div2(int n);                     /* (n+1)/2 */
int pdwt_max_level(int min_dim, int hlen);

#ifdef __cplusplus
}
#endif
#endif /* PDWT_CPU_H */

#ifdef __cplusplus
extern "C" {
#endif

/* ---- non-separable 2D engine (true 2D quads) ----
 * quads: 4 row-major (hlen x hlen) filters [LL, LH, HL, HH]
 * (H = highpass along rows; reference: src/nonseparable.cu:114-225). */
int pdwt_forward2d_ns(const pdwt_real *img, int nr, int nc, const double *quads,
                      int hlen, int levels, int swt, pdwt_real **coeffs);
int pdwt_inverse2d_ns(pdwt_real *const *coeffs, int nr, int nc,
                      const double *quads_inv, int hlen, int levels, int swt,
                      pdwt_real *img_out);

/* ---- remaining proximal ops (in place) ---- */
void pdwt_shrink(pdwt_real *x, long n, pdwt_real beta);          /* x /= 1+beta */
/* group soft threshold over 3 detail buffers (+ optional approx) of the
 * same size (reference: src/common.cu:145-198). */
void pdwt_group_soft_threshold(pdwt_real *h, pdwt_real *v, pdwt_real *d, pdwt_real *a,
                               long n, pdwt_real beta);
void pdwt_axpy(pdwt_real *y, const pdwt_real *x, long n, pdwt_real alpha);
/* Group-lasso (L2,1) norm over the same grouping as
 * pdwt_group_soft_threshold: sum_i sqrt(h^2 + v^2 + d^2 (+ a^2)). */
double pdwt_norm_l21(const pdwt_real *h, const pdwt_real *v,
                     const pdwt_real *d, const pdwt_real *a, long n);

#ifdef __cplusplus
}
#endif
