// One PPO minibatch's optimizer step over every parameter leaf at once:
// clip by global norm, Adam, the target-KL guard and the parameter update,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves optax's
// chain(clip_by_global_norm, adam) to XLA, which fuses it.  It was added
// because the port's plain version (learn/optim.py `ClipAdam.step_reference`:
// `update`, the stop select, `tree_where`, `apply_updates`) launches one
// small elementwise kernel per leaf and per term, 358 CUDA graph nodes per
// minibatch, and inside the PPO update graph every node costs ~1 us
// whatever it does.
//
// What bounds it: the launch, not bytes or operations.  Lander3D's PPO
// has 13 leaves, ~36,500 float32 parameters; the step reads p, g, mu, nu
// and writes p, mu, nu (28 bytes a parameter, ~1 MB: 0.3 us at 3.35 TB/s)
// and does ~20 operations a parameter.  So the design keeps to one launch.
//
// The design:
// - The leaves' pointers and sizes, and a map from block to (leaf, chunk)
//   built on the host, travel by value in the kernel's parameters
//   (__grid_constant__), as torch's multi_tensor_apply does: nothing is
//   copied from the host, and a CUDA graph captures the launch as one
//   node.  Leaves beyond one parameter block (kMaxLeaves, kMaxBlocks) go
//   to a further launch.
// - Every thread recomputes the global norm from the per-leaf sums of
//   squares (summed by torch on the card: their order decides the clip
//   factor's bits), left to right as Python's sum adds them, and reads the
//   bias corrections, the rate and the stop flag: a few dozen loads of the
//   same addresses, served by the caches.
// - Chunks of kChunk elements, kThreads threads a block; 16-byte loads and
//   stores where all seven pointers of a leaf are 16-byte aligned, element
//   by element otherwise (the NCCL step's gradients are views of one flat
//   buffer at any offset).
// - Thread 0 of block 0 of the first launch writes the counts.
//
// It must agree bit for bit with the plain version on the card: build with
// -fmad=false (no a*b+c contraction), use IEEE division and sqrt, round each
// Python constant to the element type as torch rounds a Python scalar, and
// keep the plain version's order of operations:
//   g' = (g / n) * m     n, m: 1, 1 under the limit, else the norm, the limit
//   mu' = (1 - b1) g' + b1 mu
//   nu' = (1 - b2) (g' g') + b2 nu
//   u = rate ((mu' / bc1) / (sqrt(nu' / bc2) + eps))
//   p' = p + (stop ? 0 : u); mu', nu', counts kept where stop holds
//
// C interface: gct_clip_adam(...) launches on the given stream and returns
// cudaGetLastError() of the first launch that failed, or -1 if the scalar
// or constant arrays have the wrong length or the element type is unknown,
// or -2 if a leaf has more chunks than an int holds; gct_error_string(code)
// names an error.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;
constexpr int kMaxLeaves = 24;
constexpr int kMaxBlocks = 256;

// the pointers of one leaf, in the wrapper's order
constexpr int kPointersPerLeaf = 7;

// the scalar tensors, in the wrapper's order (learn/optim.py step_kernel)
enum Scalar {
  kSums,       // (leaves,) element type: each leaf's sum of squares
  kBc1,        // () float64: 1 - b1^count
  kBc2,        // () float64: 1 - b2^count
  kRate,       // () element type: the schedule's rate, or null
  kCountOld,   // () int32
  kCountNew,   // () int32: the incremented count
  kCountOut,   // () int32
  kSchedOld,   // () int32
  kSchedOut,   // () int32
  kStop,       // () bool, or null: no guard
  kNumScalars
};

// the Python constants, as doubles
enum Const { kMaxNorm, kB1, kOneMinusB1, kB2, kOneMinusB2, kEps, kNegLr,
             kNumConsts };

struct Leaf {
  const void* p;
  const void* g;
  const void* mu;
  const void* nu;
  void* p_out;
  void* mu_out;
  void* nu_out;
  long long n;
};

struct Args {
  Leaf leaf[kMaxLeaves];
  int chunk[kMaxBlocks];
  unsigned char which[kMaxBlocks];
  int n_blocks;
  int n_sums;
  int write_counts;
  const void* sums;
  const double* bc1;
  const double* bc2;
  const void* rate;
  const int* count_old;
  const int* count_new;
  int* count_out;
  const int* sched_old;
  int* sched_out;
  const bool* stop;
  double c[kNumConsts];
};
static_assert(sizeof(Args) <= 4096, "kernel parameters are limited to 4 KB");

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

template <typename T>
struct Step {
  T n, m, one_b1, b1, one_b2, b2, bc1, bc2, eps, rate;
  bool stop;

  __device__ __forceinline__ void operator()(T p, T g, T mu, T nu, T& p1,
                                             T& mu1, T& nu1) const {
    const T gc = (g / n) * m;
    const T m1 = one_b1 * gc + b1 * mu;
    const T v1 = one_b2 * (gc * gc) + b2 * nu;
    const T u = rate * ((m1 / bc1) / (sqrt_(v1 / bc2) + eps));
    p1 = p + (stop ? T(0) : u);
    mu1 = stop ? mu : m1;
    nu1 = stop ? nu : v1;
  }
};

template <typename T>
__device__ Step<T> prologue(const Args& a) {
  const T* sums = static_cast<const T*>(a.sums);
  T total = T(0);
  for (int i = 0; i < a.n_sums; ++i) total = total + sums[i];
  const T norm = sqrt_(total);
  const T limit = static_cast<T>(a.c[kMaxNorm]);
  const bool under = norm < limit;
  Step<T> s;
  s.n = under ? T(1) : norm;
  s.m = under ? T(1) : limit;
  s.one_b1 = static_cast<T>(a.c[kOneMinusB1]);
  s.b1 = static_cast<T>(a.c[kB1]);
  s.one_b2 = static_cast<T>(a.c[kOneMinusB2]);
  s.b2 = static_cast<T>(a.c[kB2]);
  s.bc1 = static_cast<T>(*a.bc1);
  s.bc2 = static_cast<T>(*a.bc2);
  s.eps = static_cast<T>(a.c[kEps]);
  s.rate = a.rate != nullptr ? -*static_cast<const T*>(a.rate)
                             : static_cast<T>(a.c[kNegLr]);
  s.stop = a.stop != nullptr && *a.stop;
  return s;
}

template <typename T>
struct alignas(16) Pack {
  T e[16 / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    clip_adam_kernel(const __grid_constant__ Args a) {
  const Step<T> s = prologue<T>(a);
  if (a.write_counts && blockIdx.x == 0 && threadIdx.x == 0) {
    *a.count_out = s.stop ? *a.count_old : *a.count_new;
    const int sc = *a.sched_old;
    const int sc1 = a.rate != nullptr && sc < INT_MAX ? sc + 1 : sc;
    *a.sched_out = s.stop ? sc : sc1;
  }
  if (static_cast<int>(blockIdx.x) >= a.n_blocks) return;
  const Leaf& leaf = a.leaf[a.which[blockIdx.x]];
  const long long start =
      static_cast<long long>(a.chunk[blockIdx.x]) * kChunk;
  const int len = static_cast<int>(
      leaf.n - start < kChunk ? leaf.n - start : kChunk);
  const T* p = static_cast<const T*>(leaf.p) + start;
  const T* g = static_cast<const T*>(leaf.g) + start;
  const T* mu = static_cast<const T*>(leaf.mu) + start;
  const T* nu = static_cast<const T*>(leaf.nu) + start;
  T* p_out = static_cast<T*>(leaf.p_out) + start;
  T* mu_out = static_cast<T*>(leaf.mu_out) + start;
  T* nu_out = static_cast<T*>(leaf.nu_out) + start;

  int done = 0;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
      reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(nu) |
      reinterpret_cast<uintptr_t>(p_out) |
      reinterpret_cast<uintptr_t>(mu_out) |
      reinterpret_cast<uintptr_t>(nu_out);
  if (bits % 16 == 0) {
    constexpr int k = 16 / sizeof(T);
    const int packs = len / k;
    for (int i = threadIdx.x; i < packs; i += kThreads) {
      const Pack<T> pv = reinterpret_cast<const Pack<T>*>(p)[i];
      const Pack<T> gv = reinterpret_cast<const Pack<T>*>(g)[i];
      const Pack<T> mv = reinterpret_cast<const Pack<T>*>(mu)[i];
      const Pack<T> vv = reinterpret_cast<const Pack<T>*>(nu)[i];
      Pack<T> po, mo, vo;
#pragma unroll
      for (int j = 0; j < k; ++j)
        s(pv.e[j], gv.e[j], mv.e[j], vv.e[j], po.e[j], mo.e[j], vo.e[j]);
      reinterpret_cast<Pack<T>*>(p_out)[i] = po;
      reinterpret_cast<Pack<T>*>(mu_out)[i] = mo;
      reinterpret_cast<Pack<T>*>(nu_out)[i] = vo;
    }
    done = packs * k;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads)
    s(p[i], g[i], mu[i], nu[i], p_out[i], mu_out[i], nu_out[i]);
}

}  // namespace

// dtype: 0 float32, 1 float64.  ptrs: kPointersPerLeaf a leaf (p, g, mu,
// nu, p_out, mu_out, nu_out); numel: each leaf's elements; scalars:
// kNumScalars pointers (enum Scalar); consts: kNumConsts doubles (enum
// Const).
extern "C" int gct_clip_adam(int dtype, int n_leaves, void* const* ptrs,
                             const long long* numel,
                             const void* const* scalars, int n_scalars,
                             const double* consts, int n_consts,
                             void* stream) {
  if (n_scalars != kNumScalars || n_consts != kNumConsts ||
      (dtype != 0 && dtype != 1) || n_leaves < 0)
    return -1;
  Args a;  // the launch copies it into the kernel's parameters
  memset(&a, 0, sizeof a);
  a.n_sums = n_leaves;
  a.write_counts = 1;
  a.sums = scalars[kSums];
  a.bc1 = static_cast<const double*>(scalars[kBc1]);
  a.bc2 = static_cast<const double*>(scalars[kBc2]);
  a.rate = scalars[kRate];
  a.count_old = static_cast<const int*>(scalars[kCountOld]);
  a.count_new = static_cast<const int*>(scalars[kCountNew]);
  a.count_out = static_cast<int*>(const_cast<void*>(scalars[kCountOut]));
  a.sched_old = static_cast<const int*>(scalars[kSchedOld]);
  a.sched_out = static_cast<int*>(const_cast<void*>(scalars[kSchedOut]));
  a.stop = static_cast<const bool*>(scalars[kStop]);
  memcpy(a.c, consts, sizeof a.c);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0, n_leaf = 0;
  // launches what `a` holds (one block at least, so that the counts are
  // written even where every leaf is empty) and starts an empty map
  auto flush = [&]() {
    const int grid = a.n_blocks > 0 ? a.n_blocks : 1;
    if (dtype == 0)
      clip_adam_kernel<float><<<grid, kThreads, 0, s>>>(a);
    else
      clip_adam_kernel<double><<<grid, kThreads, 0, s>>>(a);
    const int e = static_cast<int>(cudaGetLastError());
    if (err == 0) err = e;
    a.write_counts = 0;
    a.n_blocks = 0;
    n_leaf = 0;
  };
  for (int i = 0; i < n_leaves; ++i) {
    const long long n = numel[i];
    if (n <= 0) continue;
    const long long chunks = (n + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return -2;
    if (n_leaf == kMaxLeaves) flush();
    void* const* q = ptrs + kPointersPerLeaf * i;
    const Leaf leaf{q[0], q[1], q[2], q[3], q[4], q[5], q[6], n};
    a.leaf[n_leaf] = leaf;
    for (long long c = 0; c < chunks; ++c) {
      if (a.n_blocks == kMaxBlocks) {
        flush();
        a.leaf[0] = leaf;
      }
      a.which[a.n_blocks] = static_cast<unsigned char>(n_leaf);
      a.chunk[a.n_blocks] = static_cast<int>(c);
      ++a.n_blocks;
    }
    ++n_leaf;
  }
  if (a.n_blocks > 0 || a.write_counts) flush();
  return err;
}

extern "C" const char* gct_error_string(int code) {
  if (code == -1) return "scalar or constant arrays of the wrong length, "
                         "or an unknown element type";
  if (code == -2) return "a leaf has more chunks than an int holds";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
