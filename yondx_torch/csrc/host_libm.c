/* The C library's float32 sinf, atan2f and powf over arrays.
 *
 * XLA's CPU backend evaluates sin, atan2 and pow by calling these libm
 * functions, so the port's host-side scene synthesis (data/unprocess.py)
 * calls them too: then a clean pixel equals the JAX package's bit for bit
 * and the Poisson draws that follow consume the same uniforms.
 * Built with the host C compiler by yondx_torch/core/libm.py.
 */
#include <math.h>

void yx_sinf(const float *x, float *y, long n) {
  for (long i = 0; i < n; ++i) y[i] = sinf(x[i]);
}

void yx_atan2f(const float *a, const float *b, float *y, long n) {
  for (long i = 0; i < n; ++i) y[i] = atan2f(a[i], b[i]);
}

void yx_powf(const float *x, float e, float *y, long n) {
  for (long i = 0; i < n; ++i) y[i] = powf(x[i], e);
}
