// Fused constant-action rollout of the batched copter env, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_build_kernel` of
// gym_copter_tpu/ops/pallas_rollout.py (launched by `_fused` through
// pl.pallas_call; in-kernel transition `make_env_step`, reset hash
// `_kick_u01`).  It runs `num_steps` auto-resetting transitions of B envs
// under a constant action and writes back the final state, each env's
// reward sum and its count of finished episodes.
//
// What bounds it: the instructions of a step, by their dependent latency
// while a warp scheduler has few warps, by their issue once it has several;
// not bytes.  A step is about 150 float operations and 3 sin/cos pairs per env on 23 carried
// values, and nothing but the first load and the last store touches
// device memory: at T = 10,000 the kernel moves (29+25)*4 bytes per env
// and does ~1.6e6 operations per env.  The bit-exact build needs several
// instructions per operation (accurate range reductions, IEEE division and
// square root, no contracted multiply-adds), and at a few thousand envs
// one thread per env leaves most of the card's 528 warp schedulers idle
// and exposes the latency of every dependent instruction.
//
// The design:
// - Every carried value of an env lives in registers for the whole loop.
//   Loads and stores are coalesced over the features-first rows (x[k*B+e]);
//   no shared memory.
// - A group of L adjacent lanes (L = 1 or 4) runs one env.  Every lane
//   of the group carries the whole state and runs the same instructions,
//   so the lanes never diverge and no state is ever broadcast.  The
//   independent heavy work of a step is split over the group: the three
//   sincosf, the three divisions, the square roots of the reward, and on a
//   reset the three kick hashes; each result comes back with __shfl_sync
//   over the group.  L = 1 is one thread per env (large batches, where the
//   card is issue-bound); at 4096 envs L = 4 puts one warp on each of 512
//   schedulers.  The wrapper chooses L (ops/fused_rollout.py lanes_for).
//   (L = 2 was measured and dropped: each lane still ran two sincosf, so
//   the step's chain was no shorter than at L = 1, and the shuffles made
//   it slower at every batch; see PERF.md.)
// - The task kind and the termination are template parameters, so a
//   step has no switch on them and carries no other task's code.  The lift
//   model, skip-when-landed and random reset stay uniform run-time flags.
//   The host picks the instantiation by index (kLaunch), one per (L, kind,
//   termination).
// - Blocks of 128 threads: at 4096 envs and L = 4 that is 128 blocks, one
//   per SM, four warps each.
//
// It must agree bit for bit with the plain version
// (ops/fused_rollout.py `_env_step`): build with -fmad=false (no a*b+c
// contraction), use the accurate sincosf (which gives exactly sinf's and
// cosf's bits: gct_check_sincos tests all 2^32 floats), IEEE division and
// sqrt, and keep the plain version's operand order in every expression.
//
// C interface: gct_fused_rollout(...) launches on the given stream and
// returns cudaGetLastError(), -1 if the constant arrays have the wrong
// length, or -2 if there is no instantiation for (lanes, kind,
// termination); gct_check_sincos(...) counts the floats on which sincosf
// and sinf/cosf differ; gct_error_string(code) names an error.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <array>
#include <utility>

namespace {

constexpr int kCrashed = 0;
constexpr int kLanded = 1;
constexpr int kLeveling = 2;
constexpr int kAirborne = 3;

// task kinds and terminations, in the order of ops/fused_rollout.py
// _KINDS and _TERMINATIONS
constexpr int kLander = 0;
constexpr int kLanderSimple = 1;
constexpr int kHover = 2;
constexpr int kAltHold = 3;
constexpr int kTakeoff = 4;
constexpr int kDistance = 5;
constexpr int kTarget = 6;
constexpr int kNumKinds = 7;

constexpr int kStandard = 0;
constexpr int kSimple = 1;
constexpr int kCrashOnly = 2;
constexpr int kNumTerminations = 4;  // the last, 'none', ends no episode

// lanes per env, indexed by the host's lane choice
constexpr int kLaneChoices[] = {1, 4};
constexpr int kNumLaneChoices = sizeof(kLaneChoices) / sizeof(int);
constexpr int kThreads = 128;

// Field order of ops/fused_rollout.py StepConstants.
struct Consts {
  float dt, g, Ix, Iy, Iz, iy_iz, iz_ix, ix_iy, jr_ix, jr_iy;
  float landing_vel_x, landing_vel_y, landing_angle;
  float xyz_pen, yaw_pen, pr_pen, dz_max, dz_penalty;
  float target_radius, target_radius_sq, bonus;
  float bounds, max_angle, oob_penalty;
  float althold_target, althold_tol, takeoff_target;
  float kick_scale, xy0, z0, dz0, s0;
  int ticks0, status0, max_steps, kind, termination, blade, skip_when_landed,
      random_reset;
};
constexpr int kNumFloat = 32;
constexpr int kNumInt = 8;

// The kernel's inputs and outputs, each (B,) or features-first (k, B).
struct Io {
  const float *x, *p;
  const int *status, *ticks, *steps;
  const float* pshape;
  const int *episode, *env_ids;
  const float *bz, *u2, *u3, *u4, *om;
  float *x_out, *p_out;
  int *status_out, *ticks_out, *steps_out;
  float* pshape_out;
  int* episode_out;
  float* reward_sum;
  int* episodes;
};

// per-axis salts decorrelating the three kick components
__device__ __forceinline__ uint32_t kick_axis(int a) {
  return a == 0 ? 0x2545F491u : (a == 1 ? 0x63173B93u : 0x1B56C4E9u);
}

// Counter-based uniform in [0, 1) from (env id, episode, salt, axis): the
// murmur3-fmix32-style hash of pallas_rollout.py `_kick_u01`.
__device__ __forceinline__ float kick_u01(uint32_t eid, uint32_t ep,
                                          uint32_t salt, uint32_t axis) {
  uint32_t x = eid * 0x9E3779B9u + ep * 0x85EBCA6Bu;
  x = x ^ (salt * 0xC2B2AE35u) ^ axis;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = (x ^ (x >> 16)) * 0x9E3779B1u;
  x = x ^ (x >> 16);
  return static_cast<float>(x >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// v[t] for a task index t known only at run time, by selects (a dynamic
// index into a register array would go through local memory).
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int t) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = t == k ? v[k] : r;
  return r;
}

// Runs task(t, out) for t = 0..N-1 spread over the L lanes of the group,
// task t on lane t % L (lanes past the last task repeat it), and gives
// every lane all N results: res[t][k] is output k of task t.  `mask` holds
// the group's lanes; every one of them must call this together.
template <int L, int N, int K, typename Task>
__device__ __forceinline__ void spread(unsigned mask, int lane, Task task,
                                       float (&res)[N][K]) {
  constexpr int kSlots = (N + L - 1) / L;
  float mine[kSlots][K];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + s * L;
    task(t < N ? t : N - 1, mine[s]);
  }
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (L == 1) {
        res[t][k] = mine[t][k];
      } else {
        res[t][k] = __shfl_sync(mask, mine[t / L][k], t % L, L);
      }
    }
}

// sqrtf of N arguments, spread over the group.
template <int L, int N>
__device__ __forceinline__ void spread_sqrt(unsigned mask, int lane,
                                            const float (&arg)[N],
                                            float (&out)[N]) {
  float res[N][1];
  spread<L, N, 1>(mask, lane,
                  [&](int t, float(&r)[1]) { r[0] = sqrtf(pick(arg, t)); },
                  res);
#pragma unroll
  for (int t = 0; t < N; ++t) out[t] = res[t][0];
}

template <int L, int KIND, int TERM>
__global__ void __launch_bounds__(kThreads)
    fused_rollout_kernel(const Io io, int B, int num_steps, uint32_t seed,
                         const Consts c) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = gid / L;  // the env
  // A group's lanes share i and leave together: no lane that another
  // lane's shuffle names has left (the masks below hold only the group).
  if (i >= B) return;
  const int lane = threadIdx.x & (L - 1);
  const unsigned mask = ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));

  float x[12], p[6];
#pragma unroll
  for (int k = 0; k < 12; ++k) x[k] = io.x[k * B + i];
#pragma unroll
  for (int k = 0; k < 6; ++k) p[k] = io.p[k * B + i];
  int status = io.status[i];
  int ticks = io.ticks[i];
  int steps = io.steps[i];
  float pshape = io.pshape[i];
  int ep = io.episode[i];
  const uint32_t eid = static_cast<uint32_t>(io.env_ids[i]);
  const float bz = io.bz[i], u2 = io.u2[i], u3 = io.u3[i], u4 = io.u4[i];
  const float om = io.om[i];
  float acc = 0.0f;
  int eps = 0;

  for (int t = 0; t < num_steps; ++t) {
    const bool entry_landed = status == kLanded;

    // the state-only heavy work: sincos of phi, theta, psi and the three
    // inertia quotients of core/dynamics.step (task t: angle x[6+2t];
    // ((a*b)*k)/I with (a, b) = (x11, x9), (x11, x7), (x9, x7))
    float h[3][3];
    spread<L, 3, 3>(mask, lane, [&](int tk, float(&r)[3]) {
      const float ang = tk == 0 ? x[6] : (tk == 1 ? x[8] : x[10]);
      sincosf(ang, &r[0], &r[1]);
      const float a = tk == 2 ? x[9] : x[11];
      const float b = tk == 0 ? x[9] : x[7];
      const float k = tk == 0 ? c.iy_iz : (tk == 1 ? c.iz_ix : c.ix_iy);
      const float den = tk == 0 ? c.Ix : (tk == 1 ? c.Iy : c.Iz);
      r[2] = ((a * b) * k) / den;
    }, h);
    const float sph = h[0][0], cph = h[0][1];
    const float sth = h[1][0], cth = h[1][1];
    const float sps = h[2][0], cps = h[2][1];

    // dynamics (core/dynamics.step, identical operand order)
    const float rx = sph * sps + (cph * cps) * sth;
    const float ry = (cph * sps) * sth - cps * sph;
    const float rz = cph * cth;
    const float ax = bz * rx, ay = bz * ry, az = bz * rz;
    const float netz = az + c.g;

    const int status1 = (entry_landed && netz < 0.0f) ? kAirborne : status;
    const bool leveling = status1 == kLeveling;
    const bool airborne = status1 == kAirborne;
    const bool touchdown = airborne && (x[4] > 0.0f) && (x[5] > 0.0f);
    const bool crash = (x[5] > c.landing_vel_y) ||
                       (fabsf(x[3]) > c.landing_vel_x) ||
                       (fabsf(x[6]) > c.landing_angle);
    const bool integrate = airborne && !touchdown;

    float phi_dd, the_dd;
    if (c.blade) {
      phi_dd = ((h[0][2] - (c.jr_ix * x[9]) * om) + u2) + p[3];
      the_dd = -((h[1][2] + (c.jr_iy * x[7]) * om) + u3) + p[4];
    } else {
      phi_dd = (h[0][2] + u2) + p[3];
      the_dd = -(h[1][2] + u3) + p[4];
    }
    const float psi_dd = (h[2][2] + u4) + p[5];
    // the perturbation double-count of core/dynamics.step
    const float d[12] = {x[1],  (ax + p[0]) + p[0],   x[3],
                         (ay + p[1]) + p[1],  x[5],   (netz + p[2]) + p[2],
                         x[7],  phi_dd + p[3],        x[9],
                         the_dd + p[4],       x[11],  psi_dd + p[5]};

    // landed envs skip the dynamics unless the task flies from the ground
    const bool skip = c.skip_when_landed && entry_landed;
    const bool eff_integ = integrate && !skip;
    const bool eff_level = leveling && !skip;
    const bool keep_p = skip || touchdown;
    float y[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) y[k] = eff_integ ? x[k] + c.dt * d[k] : x[k];
    if (eff_level) {
      y[6] = 0.0f;
      y[8] = 0.0f;
    }
    const int status_n =
        skip ? status
             : (leveling ? kLanded
                         : (touchdown ? (crash ? kCrashed : kLeveling)
                                      : status1));
    const int ticks_n = ticks + (keep_p ? 0 : 1);

    // reward (envs/base._reward)
    float shaping = 0.0f, reward;
    bool done = false;
    if constexpr (KIND == kLander) {
      const float arg[3] = {
          y[0] * y[0] + y[1] * y[1] + y[2] * y[2] + y[3] * y[3] +
              y[4] * y[4] + y[5] * y[5],
          y[10] * y[10] + y[11] * y[11], y[0] * y[0] + y[2] * y[2]};
      float rt[3];
      spread_sqrt<L, 3>(mask, lane, arg, rt);
      shaping = -(c.xyz_pen * rt[0] + c.yaw_pen * rt[1]);
      shaping = shaping - (fabsf(y[5]) > c.dz_max ? c.dz_penalty : 0.0f);
      reward = shaping - pshape;
      const bool inside = rt[2] < c.target_radius;
      reward = reward + ((entry_landed && inside) ? c.bonus : 0.0f);
      done = entry_landed;
    } else if constexpr (KIND == kLanderSimple) {
      // the bonus comes after the 'simple' termination below
      const float arg[2] = {
          y[0] * y[0] + y[1] * y[1] + y[2] * y[2] + y[3] * y[3] +
              y[4] * y[4] + y[5] * y[5],
          y[6] * y[6] + y[7] * y[7] + y[8] * y[8] + y[9] * y[9]};
      float rt[2];
      spread_sqrt<L, 2>(mask, lane, arg, rt);
      shaping = -(c.xyz_pen * rt[0] + c.pr_pen * rt[1]);
      reward = shaping - pshape;
      done = entry_landed;
    } else if constexpr (KIND == kAltHold) {
      reward =
          (fabsf(-y[4] - c.althold_target) < c.althold_tol) ? 1.0f : 0.0f;
    } else if constexpr (KIND == kTakeoff) {
      shaping = -fabsf(-y[4] - c.takeoff_target);
      reward = shaping - pshape;
    } else if constexpr (KIND == kDistance) {
      shaping = sqrtf(y[0] * y[0] + y[2] * y[2]);
      reward = shaping - pshape;
    } else if constexpr (KIND == kTarget) {
      reward = 0.0f;
    } else {  // hover: +1 per surviving step
      reward = 1.0f;
    }

    if constexpr (TERM == kCrashOnly) {
      done = done || (status_n == kCrashed);
    } else if constexpr (TERM == kStandard || TERM == kSimple) {
      const bool oob = (fabsf(y[0]) >= c.bounds) || (fabsf(y[2]) >= c.bounds);
      const bool tilt =
          (fabsf(y[6]) >= c.max_angle) || (fabsf(y[8]) >= c.max_angle);
      const bool crashed = status == kCrashed;
      if constexpr (TERM == kSimple) {
        if (oob || tilt) reward = -c.oob_penalty;
        const bool inside = y[0] * y[0] + y[2] * y[2] < c.target_radius_sq;
        reward = reward + ((entry_landed && inside) ? c.bonus : 0.0f);
      } else {
        reward = oob ? reward - c.oob_penalty
                     : (tilt ? -c.oob_penalty : reward);
      }
      done = done || oob || tilt || crashed;
    }
    done = done || (steps == c.max_steps);

    acc = acc + reward;
    // done is the same on every lane of the group: the branch is uniform
    // over the group, and its shuffles name the group alone
    if (done) {
      // auto-reset to the default pose, with a fresh wind kick
      const int ep1 = ep + 1;
      float kick[3][1] = {{0.0f}, {0.0f}, {0.0f}};
      if (c.random_reset) {
        spread<L, 3, 1>(mask, lane, [&](int a, float(&r)[1]) {
          r[0] = (2.0f * kick_u01(eid, static_cast<uint32_t>(ep1), seed,
                                  kick_axis(a)) -
                  1.0f) *
                 c.kick_scale;
        }, kick);
      }
      x[0] = c.xy0;
      x[1] = 0.0f;
      x[2] = c.xy0;
      x[3] = 0.0f;
      x[4] = c.z0;
      x[5] = c.dz0;
#pragma unroll
      for (int k = 6; k < 12; ++k) x[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = kick[k][0];
#pragma unroll
      for (int k = 3; k < 6; ++k) p[k] = 0.0f;
      status = c.status0;
      ticks = c.ticks0;
      steps = 1;
      pshape = c.s0;
      ep = ep1;
      eps += 1;
    } else {
#pragma unroll
      for (int k = 0; k < 12; ++k) x[k] = y[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) p[k] = keep_p ? p[k] : 0.0f;
      status = status_n;
      ticks = ticks_n;
      steps = steps + 1;
      pshape = shaping;
    }
  }

  if (lane != 0) return;
#pragma unroll
  for (int k = 0; k < 12; ++k) io.x_out[k * B + i] = x[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) io.p_out[k * B + i] = p[k];
  io.status_out[i] = status;
  io.ticks_out[i] = ticks;
  io.steps_out[i] = steps;
  io.pshape_out[i] = pshape;
  io.episode_out[i] = ep;
  io.reward_sum[i] = acc;
  io.episodes[i] = eps;
}

using Launch = void (*)(const Io&, int, int, uint32_t, const Consts&,
                        cudaStream_t);

// Instantiation I of the kernel: lanes kLaneChoices[I / (kinds *
// terminations)], then kind, then termination.
template <size_t I>
void launch_at(const Io& io, int B, int num_steps, uint32_t seed,
               const Consts& c, cudaStream_t stream) {
  constexpr int kPerLane = kNumKinds * kNumTerminations;
  constexpr int L = kLaneChoices[I / kPerLane];
  constexpr int kind = static_cast<int>(I % kPerLane) / kNumTerminations;
  constexpr int term = static_cast<int>(I % kNumTerminations);
  const int blocks = static_cast<int>(
      (static_cast<long long>(B) * L + kThreads - 1) / kThreads);
  fused_rollout_kernel<L, kind, term>
      <<<blocks, kThreads, 0, stream>>>(io, B, num_steps, seed, c);
}

template <size_t... I>
constexpr std::array<Launch, sizeof...(I)> launch_table(
    std::index_sequence<I...>) {
  return {{&launch_at<I>...}};
}

constexpr auto kLaunch = launch_table(std::make_index_sequence<
    kNumLaneChoices * kNumKinds * kNumTerminations>());

// Every float32 bit pattern, grid-strided: counts the values whose
// sincosf differs from sinf or cosf in any bit (a NaN against a NaN is
// equal).
__global__ void check_sincos_kernel(unsigned long long* differ) {
  unsigned long long n = 0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t v = blockIdx.x * blockDim.x + threadIdx.x; v < (1ull << 32);
       v += stride) {
    const float a = __uint_as_float(static_cast<uint32_t>(v));
    float s, co;
    sincosf(a, &s, &co);
    const float s1 = sinf(a), c1 = cosf(a);
    const bool same_s = __float_as_uint(s) == __float_as_uint(s1) ||
                        (isnan(s) && isnan(s1));
    const bool same_c = __float_as_uint(co) == __float_as_uint(c1) ||
                        (isnan(co) && isnan(c1));
    n += (same_s && same_c) ? 0 : 1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xFFFFFFFFu, n, o);
  if ((threadIdx.x & 31) == 0 && n != 0) atomicAdd(differ, n);
}

}  // namespace

extern "C" int gct_fused_rollout(
    const void* x, const void* p, const void* status, const void* ticks,
    const void* steps, const void* pshape, const void* episode,
    const void* env_ids, const void* bz, const void* u2, const void* u3,
    const void* u4, const void* om, void* x_out, void* p_out,
    void* status_out, void* ticks_out, void* steps_out, void* pshape_out,
    void* episode_out, void* reward_sum, void* episodes, int B, int num_steps,
    int seed, int lanes, const float* fconsts, int n_float,
    const int* iconsts, int n_int, void* stream) {
  if (n_float != kNumFloat || n_int != kNumInt) return -1;
  static_assert(offsetof(Consts, ticks0) == kNumFloat * sizeof(float) &&
                    sizeof(Consts) == offsetof(Consts, ticks0) +
                                          kNumInt * sizeof(int),
                "Consts must hold exactly the float then the int constants");
  Consts c;
  memcpy(&c, fconsts, kNumFloat * sizeof(float));
  memcpy(reinterpret_cast<char*>(&c) + offsetof(Consts, ticks0), iconsts,
         kNumInt * sizeof(int));
  const int lane_choice = lanes == 1 ? 0 : (lanes == 4 ? 1 : -1);
  if (lane_choice < 0 || c.kind < 0 || c.kind >= kNumKinds ||
      c.termination < 0 || c.termination >= kNumTerminations)
    return -2;
  const Io io{
      static_cast<const float*>(x),      static_cast<const float*>(p),
      static_cast<const int*>(status),   static_cast<const int*>(ticks),
      static_cast<const int*>(steps),    static_cast<const float*>(pshape),
      static_cast<const int*>(episode),  static_cast<const int*>(env_ids),
      static_cast<const float*>(bz),     static_cast<const float*>(u2),
      static_cast<const float*>(u3),     static_cast<const float*>(u4),
      static_cast<const float*>(om),     static_cast<float*>(x_out),
      static_cast<float*>(p_out),        static_cast<int*>(status_out),
      static_cast<int*>(ticks_out),      static_cast<int*>(steps_out),
      static_cast<float*>(pshape_out),   static_cast<int*>(episode_out),
      static_cast<float*>(reward_sum),   static_cast<int*>(episodes)};
  if (B > 0)
    kLaunch[(lane_choice * kNumKinds + c.kind) * kNumTerminations +
            c.termination](io, B, num_steps, static_cast<uint32_t>(seed), c,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Counts into *differ (a zeroed device uint64) the float32 values on
// which sincosf and sinf/cosf differ.
extern "C" int gct_check_sincos(void* differ, void* stream) {
  check_sincos_kernel<<<132 * 16, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(differ));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gct_error_string(int code) {
  if (code == -1) return "constant arrays do not match struct Consts";
  if (code == -2) return "no kernel instantiation for these lanes, kind "
                         "and termination";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
