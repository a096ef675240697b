// The batched env step with its auto-reset, for Hopper (sm_90a): the
// transition, the threefry reset draw, the select and the observation of
// B envs in one launch.
//
// Replaces no TPU kernel: the JAX package leaves envs/base.py `step` to
// XLA, which fuses it.  It was added because the port's plain version
// (envs/base.py `step_reference`) launches one small kernel per operation:
// ~770 CUDA graph nodes per step, ~580 of them the reset's threefry2x32
// emulated on int64 words, and inside a graph every node costs ~1.1 us
// whatever it does.  The PPO rollout, the B = 1 step, the evolutionary
// fitness and the experts replay that graph at every env step.
//
// What bounds it: the launch, not bytes or operations.  A step reads 30
// values per env (the state's 24, the four mixed motor values, their sum,
// the env id) and writes 48 and two flags (the next state's 24, Lander3D's
// 10 observations, reward, status, the 12 values of the state before the
// select; done, spinning): 314 bytes per env in float32, 1.29 MB at 4096
// envs, 0.38 us at 3.35 TB/s.  It does ~200 float operations per env, and
// ~1,000 integer operations more on a reset (five threefry2x32 of 20
// rounds): a few us of one thread's dependent chain.
//
// The design:
// - One thread per env, blocks of 128.  Every carried value lives in
//   registers; loads and stores are coalesced over the features-first rows
//   (x[k*B+e]).  At B = 1 the kernel runs one thread.
// - The action -> motors map, the (4, A) mix (a cuBLAS product) and the
//   motors' sum (the `spinning` flag) stay torch ops before the launch, so
//   their bits are torch's by construction.
// - The reset is computed only for the envs that finish: the plain version
//   computes it for every env and selects, with the same result.
// - The dynamics step and the kick draw depend on the float type alone and
//   are not inlined, so that the 56 instantiations share one copy of each
//   (and of the double sin/cos slow paths): nvcc builds the file in ~34 s
//   instead of ~43 s.  With -fmad=false a call rounds as inlined code does.
// - The task kind, the termination and the float type are template
//   parameters, so a step has no switch on them and carries no other task's
//   code.  The lift model, skip-when-landed, perturb-on-reset,
//   integrate-on-reset and the observation rows are uniform run-time
//   flags.  The host picks the instantiation by index (kLaunch).
// - The base key and the env ids are read from device memory at every
//   launch, so a captured graph that replays the step draws with the key
//   as it is at the replay.
//
// It must agree bit for bit with the plain version on the card: build with
// -fmad=false (no a*b+c contraction), use the accurate sinf/cosf (sin/cos
// in double), IEEE division and sqrt, round each Python constant to the
// element type as torch rounds a Python scalar (via float32 where the
// plain version makes a float32 tensor of it first), and keep the plain
// version's order of operations.  Two orders are torch's own:
// - torch.sum over the features of an (N, B) slice (the lander shapings'
//   sums of squares), as PyTorch's CUDA reduction adds them (`torch_sum`,
//   found on torch 2.11 by trying every association on the card);
// - threefry2x32 and `uniform` as core/prng.py computes them, here in
//   uint32 words.
//
// C interface: gct_env_step(...) launches on the given stream and returns
// cudaGetLastError(), -1 if the pointer or constant arrays have the wrong
// length, or -2 if there is no instantiation for (type, kind,
// termination); gct_error_string(code) names an error.

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

// task kinds and terminations, in the order of envs/base.py KERNEL_KINDS
// and KERNEL_TERMINATIONS
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
constexpr int kNone = 3;
constexpr int kNumTerminations = 4;

// element types, in the order of envs/base.py KERNEL_DTYPES
constexpr int kNumTypes = 2;  // float32, float64

constexpr int kThreads = 128;
constexpr int kMaxObs = 12;

constexpr double kPi = 3.141592653589793;  // math.pi
constexpr double kDegToRad = 3.141592653589793 / 180.0;

// Field order of envs/base.py KernelConstants: the doubles, then the ints.
struct Consts {
  double maxrpm, half_l, lift_k, thrust_b, lb, drag_d, mass, ix, iy, iz,
      iy_iz, iz_ix, ix_iy, jr_ix, jr_iy, g, dt, landing_vel_x,
      landing_vel_y, landing_angle, xyz_pen, yaw_pen, pr_pen, dz_max,
      dz_penalty, target_radius, target_radius_sq, bonus, althold_target,
      althold_tol, takeoff_target, bounds, max_angle, oob_penalty, force,
      pose_x, pose_y, pose_z, pose_phi, pose_theta, dtheta, orbit_radius,
      target_alt;
  int max_steps, blade, skip_when_landed, perturb_on_reset,
      integrate_on_reset, negate_obs, n_obs, obs0, obs1, obs2, obs3, obs4,
      obs5, obs6, obs7, obs8, obs9, obs10, obs11;
};
constexpr int kNumFloat = 43;
constexpr int kNumInt = 19;

// The kernel's tensors, in the order of envs/base.py `step_kernel`.
enum Pointer {
  kX, kP, kStatus, kTicks, kSteps, kPshape, kEpisode, kIrx,  // the state
  kMotors, kMotorSum, kKey, kEnvIds,                         // the step's
  kXOut, kPOut, kStatusOut, kTicksOut, kStepsOut, kPshapeOut, kEpisodeOut,
  kIrxOut,                                                   // next state
  kObs, kReward, kDone, kTsStatus, kSpinning, kTsX,          // TimeStep
  kNumPointers
};

template <typename T>
struct Io {
  const T *x, *p;
  const int *status, *ticks, *steps;
  const T* pshape;
  const int* episode;
  const T* irx;
  const T *motors, *motor_sum;
  const long long* key;
  const int* env_ids;
  T *x_out, *p_out;
  int *status_out, *ticks_out, *steps_out;
  T* pshape_out;
  int* episode_out;
  T* irx_out;
  T *obs, *reward;
  bool* done;
  int* ts_status;
  bool* spinning;
  T* ts_x;
};

__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }

// A Python float as torch rounds a Python scalar to the element type.
template <typename T>
__device__ __forceinline__ T cst(double v) {
  return static_cast<T>(v);
}

// torch.sum(v, dim=0) of an (N, B) slice of a features-first state, in
// the order PyTorch's CUDA reduction adds it.  For B > 1 one thread sums
// each column with four accumulators, input k into accumulator k % 4,
// combined left to right: (((v0 + v4) + (v1 + v5)) + v2) + v3 for N = 6.
// For B = 1 the N values are one contiguous full reduction: two lanes take
// the even and the odd inputs, each with two accumulators taking its
// inputs in turn, and the lanes are added: ((v0 + v4) + v2) + ((v1 + v5)
// + v3) for N = 6.  Each accumulator starts at 0, which adds exactly to
// the non-negative squares summed here.
template <int N, typename T>
__device__ __forceinline__ T torch_sum(const T (&v)[N], bool single) {
  if (single) {
    T lane[2];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      T a = T(0), b = T(0);
#pragma unroll
      for (int k = l, j = 0; k < N; k += 2, ++j) {
        if (j % 2 == 0) a = a + v[k];
        else b = b + v[k];
      }
      lane[l] = a + b;
    }
    return lane[0] + lane[1];
  }
  T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k % 4] = acc[k % 4] + v[k];
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

// ---- threefry2x32 (core/prng.py), on uint32 words ----------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t c1, uint32_t c2,
                                             uint32_t& o1, uint32_t& o2) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  uint32_t x0 = c1 + ks[0];
  uint32_t x1 = c2 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 = x0 + x1;
      x1 = rotl(x1, kRot[i % 2][r]) ^ x0;
    }
    x0 = x0 + ks[(i + 1) % 3];
    x1 = x1 + ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  o1 = x0;
  o2 = x1;
}

// A float in [1, 2) from the two words, as `jax.random.uniform` makes it
// (prng._unit_floats): the top bits of the 32-bit draw b1 ^ b2 (float32)
// or of the 64-bit draw (b1 << 32) | b2 (float64).
__device__ __forceinline__ float unit_float(uint32_t b1, uint32_t b2, float) {
  return __uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u);
}
__device__ __forceinline__ double unit_float(uint32_t b1, uint32_t b2,
                                             double) {
  const uint64_t bits = (static_cast<uint64_t>(b1) << 20) |
                        (static_cast<uint64_t>(b2) >> 12) |
                        0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(bits));
}

// The reset's wind kick (envs/base._initial_forces): uniform(fold_in(
// fold_in(key, env_id), episode), 3, -F, F), as prng.uniform computes
// symmetric bounds: max(-F, F * ((f * 2) - 1)) with f in [0, 1).
template <typename T>
__device__ __noinline__ void kick(const long long* key, uint32_t eid,
                                     uint32_t episode, T force, T (&f)[3]) {
  uint32_t a0, a1, b0, b1;
  threefry2x32(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]),
               0u, eid, a0, a1);
  threefry2x32(a0, a1, 0u, episode, b0, b1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint32_t w1, w2;
    threefry2x32(b0, b1, 0u, static_cast<uint32_t>(k), w1, w2);
    const T u = unit_float(w1, w2, T(0)) - T(1);
    const T v = force * (u * T(2) - T(1));
    f[k] = fmax(-force, v);
  }
}

// ---- the transition (core/dynamics.py) ----------------------------------

template <typename T>
struct Mix {
  T bz, u2, u3, u4, om;
};

// dynamics.motor_mix_terms of the mixed motor values m.
template <typename T>
__device__ __forceinline__ Mix<T> mix_terms(const T (&m)[4],
                                            const Consts& c) {
  T w[4], w2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = ((m[k] * cst<T>(c.maxrpm)) * cst<T>(kPi)) / cst<T>(30.0);
    w2[k] = w[k] * w[k];
  }
  T u1, u2, u3, om;
  if (c.blade) {
    T lift[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T v = w[k] * cst<T>(c.half_l);
      lift[k] = cst<T>(c.lift_k) * (v * v);
    }
    u1 = ((lift[0] + lift[1]) + lift[2]) + lift[3];
    u2 = (lift[1] + lift[2]) - (lift[0] + lift[3]);
    u3 = (lift[1] + lift[3]) - (lift[0] + lift[2]);
    om = (w[0] + w[1]) - (w[2] + w[3]);
  } else {
    u1 = cst<T>(c.thrust_b) * (((w2[0] + w2[1]) + w2[2]) + w2[3]);
    u2 = cst<T>(c.lb) * ((w2[1] + w2[2]) - (w2[0] + w2[3]));
    u3 = cst<T>(c.lb) * ((w2[1] + w2[3]) - (w2[0] + w2[2]));
    om = T(0);
  }
  const T u4 = cst<T>(c.drag_d) * ((w2[0] + w2[1]) - (w2[2] + w2[3]));
  return {(-u1) / cst<T>(c.mass), u2 / cst<T>(c.ix), u3 / cst<T>(c.iy),
          u4 / cst<T>(c.iz), om};
}

template <typename T>
struct Dyn {
  T x[12];
  T p[6];
  int status, ticks;
};

// One dynamics.step of s under the motor terms u.
template <typename T>
__device__ __noinline__ void dyn_step(Dyn<T>& s, const Mix<T>& u,
                                      const Consts& c) {
  const T* x = s.x;
  const T* p = s.p;
  const T cph = cos_(x[6]), sph = sin_(x[6]);
  const T cth = cos_(x[8]), sth = sin_(x[8]);
  const T cps = cos_(x[10]), sps = sin_(x[10]);
  const T rx = sph * sps + (cph * cps) * sth;
  const T ry = (cph * sps) * sth - cps * sph;
  const T rz = cph * cth;
  const T ax = u.bz * rx, ay = u.bz * ry, az = u.bz * rz;
  const T netz = az + cst<T>(c.g);

  const int status1 =
      (s.status == kLanded && netz < T(0)) ? kAirborne : s.status;
  const bool leveling = status1 == kLeveling;
  const bool airborne = status1 == kAirborne;
  const bool touchdown = airborne && (x[4] > T(0)) && (x[5] > T(0));
  const bool crash = (x[5] > cst<T>(c.landing_vel_y)) ||
                     (abs_(x[3]) > cst<T>(c.landing_vel_x)) ||
                     (abs_(x[6]) > cst<T>(c.landing_angle));
  const bool integrate = airborne && !touchdown;

  const T q1 = ((x[11] * x[9]) * cst<T>(c.iy_iz)) / cst<T>(c.ix);
  const T q2 = ((x[11] * x[7]) * cst<T>(c.iz_ix)) / cst<T>(c.iy);
  const T q3 = ((x[9] * x[7]) * cst<T>(c.ix_iy)) / cst<T>(c.iz);
  T phi_dd, the_dd;
  if (c.blade) {
    phi_dd = ((q1 - (cst<T>(c.jr_ix) * x[9]) * u.om) + u.u2) + p[3];
    the_dd = -((q2 + (cst<T>(c.jr_iy) * x[7]) * u.om) + u.u3) + p[4];
  } else {
    phi_dd = (q1 + u.u2) + p[3];
    the_dd = -(q2 + u.u3) + p[4];
  }
  // the perturbation double-count of dynamics.step
  const T d[12] = {x[1],  (ax + p[0]) + p[0],   x[3],
                   (ay + p[1]) + p[1],  x[5],   (netz + p[2]) + p[2],
                   x[7],  phi_dd + p[3],        x[9],
                   the_dd + p[4],       x[11],  ((q3 + u.u4) + p[5]) + p[5]};
  const T dt = cst<T>(c.dt);
  if (integrate) {
#pragma unroll
    for (int k = 0; k < 12; ++k) s.x[k] = x[k] + dt * d[k];
  } else if (leveling) {
    s.x[6] = T(0);
    s.x[8] = T(0);
  }
  s.status = leveling ? kLanded
                      : (touchdown ? (crash ? kCrashed : kLeveling) : status1);
  if (!touchdown) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s.p[k] = T(0);
  }
  s.ticks = s.ticks + (touchdown ? 0 : 1);
}

// envs/base._shaping of the state x.
template <int KIND, typename T>
__device__ __forceinline__ T shaping_of(const T (&x)[12], const Consts& c,
                                        bool single) {
  if constexpr (KIND == kLander) {
    const T pos[6] = {x[0] * x[0], x[1] * x[1], x[2] * x[2],
                      x[3] * x[3], x[4] * x[4], x[5] * x[5]};
    const T yaw[2] = {x[10] * x[10], x[11] * x[11]};
    const T s = -(cst<T>(c.xyz_pen) * sqrt_(torch_sum(pos, single)) +
                  cst<T>(c.yaw_pen) * sqrt_(torch_sum(yaw, single)));
    return s - (abs_(x[5]) > cst<T>(c.dz_max) ? cst<T>(c.dz_penalty) : T(0));
  } else if constexpr (KIND == kLanderSimple) {
    const T pos[6] = {x[0] * x[0], x[1] * x[1], x[2] * x[2],
                      x[3] * x[3], x[4] * x[4], x[5] * x[5]};
    const T ang[4] = {x[6] * x[6], x[7] * x[7], x[8] * x[8], x[9] * x[9]};
    return -(cst<T>(c.xyz_pen) * sqrt_(torch_sum(pos, single)) +
             cst<T>(c.pr_pen) * sqrt_(torch_sum(ang, single)));
  } else if constexpr (KIND == kTakeoff) {
    return -abs_(-x[4] - cst<T>(c.takeoff_target));
  } else if constexpr (KIND == kDistance) {
    return sqrt_(x[0] * x[0] + x[2] * x[2]);
  } else {
    return T(0);
  }
}

// envs/base._get_obs of the state x at step count `steps`, into column i
// of obs: the n_obs state rows, then the target kind's three.
template <int KIND, typename T>
__device__ __forceinline__ void write_obs(const T (&x)[12], int steps,
                                          const Consts& c, T* obs,
                                          long long B, long long i) {
  const int rows[kMaxObs] = {c.obs0, c.obs1, c.obs2, c.obs3,
                             c.obs4, c.obs5, c.obs6, c.obs7,
                             c.obs8, c.obs9, c.obs10, c.obs11};
#pragma unroll
  for (int r = 0; r < kMaxObs; ++r) {
    if (r >= c.n_obs) break;
    T v = x[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) v = rows[r] == k ? x[k] : v;
    obs[r * B + i] = c.negate_obs ? -v : v;
  }
  if constexpr (KIND == kTarget) {
    const T theta = cst<T>(c.dtheta) * static_cast<T>(steps - 1);
    const long long n = c.n_obs;
    obs[n * B + i] = cst<T>(c.orbit_radius) * cos_(theta);
    obs[(n + 1) * B + i] = cst<T>(c.orbit_radius) * sin_(theta);
    obs[(n + 2) * B + i] = cst<T>(c.target_alt);
  }
}

template <int KIND, int TERM, typename T>
__global__ void __launch_bounds__(kThreads)
    env_step_kernel(const Io<T> io, long long B, const Consts c) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= B) return;
  const bool single = B == 1;

  // the entry state
  Dyn<T> s;
#pragma unroll
  for (int k = 0; k < 12; ++k) s.x[k] = io.x[k * B + i];
#pragma unroll
  for (int k = 0; k < 6; ++k) s.p[k] = io.p[k * B + i];
  s.status = io.status[i];
  s.ticks = io.ticks[i];
  const int entry_status = s.status;
  const int steps = io.steps[i];
  const T pshape = io.pshape[i];
  const int episode = io.episode[i];
  T m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = io.motors[k * B + i];
  const bool landed = entry_status == kLanded;
  const bool spinning = !landed && io.motor_sum[i] > T(0);

  // the transition (envs/base._raw_step); landed envs keep their whole
  // dynamics state unless the task drives them from the ground
  if (!(c.skip_when_landed && landed)) dyn_step(s, mix_terms(m, c), c);
  const T* x = s.x;

  // the reward (envs/base._reward)
  T shaping = T(0), reward;
  bool done = false;
  if constexpr (KIND == kLander) {
    shaping = shaping_of<KIND>(s.x, c, single);
    reward = shaping - pshape;
    const bool inside =
        sqrt_(x[0] * x[0] + x[2] * x[2]) < cst<T>(c.target_radius);
    reward = reward + ((landed && inside) ? cst<T>(c.bonus) : T(0));
    done = landed;
  } else if constexpr (KIND == kLanderSimple) {
    shaping = shaping_of<KIND>(s.x, c, single);
    reward = shaping - pshape;
    done = landed;
  } else if constexpr (KIND == kAltHold) {
    reward = abs_(-x[4] - cst<T>(c.althold_target)) < cst<T>(c.althold_tol)
                 ? T(1)
                 : T(0);
  } else if constexpr (KIND == kTakeoff || KIND == kDistance) {
    shaping = shaping_of<KIND>(s.x, c, single);
    reward = shaping - pshape;
  } else if constexpr (KIND == kTarget) {
    reward = T(0);
  } else {  // hover: +1 per step
    reward = T(1);
  }

  // the termination (envs/base._raw_step)
  if constexpr (TERM == kStandard || TERM == kSimple) {
    const bool oob = (abs_(x[0]) >= cst<T>(c.bounds)) ||
                     (abs_(x[2]) >= cst<T>(c.bounds));
    const bool tilt = (abs_(x[6]) >= cst<T>(c.max_angle)) ||
                      (abs_(x[8]) >= cst<T>(c.max_angle));
    const bool crashed = entry_status == kCrashed;
    const T penalty = cst<T>(c.oob_penalty);
    if constexpr (TERM == kStandard) {
      // out-of-bounds subtracts the penalty; tilt replaces the reward
      reward = oob ? reward - penalty : (tilt ? -penalty : reward);
    } else {
      // both replace the reward, and the squared-radius bonus follows
      reward = (oob || tilt) ? -penalty : reward;
      const bool inside =
          x[0] * x[0] + x[2] * x[2] < cst<T>(c.target_radius_sq);
      reward = reward + ((landed && inside) ? cst<T>(c.bonus) : T(0));
    }
    done = done || oob || tilt || crashed;
  } else if constexpr (TERM == kCrashOnly) {
    done = s.status == kCrashed;
  } else {  // kNone ends no episode but at max_steps
    done = false;
  }
  done = done || (steps == c.max_steps);

  // the TimeStep's fields of the finished step
#pragma unroll
  for (int k = 0; k < 12; ++k) io.ts_x[k * B + i] = x[k];
  io.ts_status[i] = s.status;
  io.reward[i] = reward;
  io.done[i] = done;
  io.spinning[i] = spinning;

  int steps_out = steps + 1, episode_out = episode;
  T irx = io.irx[i];
  if (done) {
    // the auto-reset (envs/base.reset at the task's pose, episode + 1)
    episode_out = episode + 1;
    T f[3] = {T(0), T(0), T(0)};
    if (c.perturb_on_reset)
      kick(io.key, static_cast<uint32_t>(io.env_ids[i]),
           static_cast<uint32_t>(episode_out), cst<T>(c.force), f);
#pragma unroll
    for (int k = 0; k < 12; ++k) s.x[k] = T(0);
    s.x[0] = cst<T>(c.pose_x);
    s.x[2] = cst<T>(c.pose_y);
    s.x[4] = cst<T>(c.pose_z);
    s.x[6] = cst<T>(c.pose_phi) * cst<T>(kDegToRad);
    s.x[8] = cst<T>(c.pose_theta) * cst<T>(kDegToRad);
    s.status = s.x[4] < T(0) ? kAirborne : kLanded;
    s.ticks = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) s.p[k] = f[k] / cst<T>(c.mass);
#pragma unroll
    for (int k = 3; k < 6; ++k) s.p[k] = T(0) / cst<T>(c.mass);
    if (c.integrate_on_reset) {
      // the attic simple task's reset is a zero-demand step
      const T zero[4] = {T(0), T(0), T(0), T(0)};
      dyn_step(s, mix_terms(zero, c), c);
    }
    shaping = shaping_of<KIND>(s.x, c, single);
    steps_out = 1;
    irx = static_cast<T>((T(0) < f[1]) - (f[1] < T(0)));
  }

  // the selected state and its observation
#pragma unroll
  for (int k = 0; k < 12; ++k) io.x_out[k * B + i] = s.x[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) io.p_out[k * B + i] = s.p[k];
  io.status_out[i] = s.status;
  io.ticks_out[i] = s.ticks;
  io.steps_out[i] = steps_out;
  io.pshape_out[i] = shaping;
  io.episode_out[i] = episode_out;
  io.irx_out[i] = irx;
  // the target's rows read the entry step count, or 1 after a reset
  write_obs<KIND>(s.x, done ? 1 : steps, c, io.obs, B, i);
}

using Launch = void (*)(void* const*, long long, const Consts&,
                        cudaStream_t);

template <typename T>
Io<T> io_of(void* const* ptr) {
  Io<T> io;
  io.x = static_cast<const T*>(ptr[kX]);
  io.p = static_cast<const T*>(ptr[kP]);
  io.status = static_cast<const int*>(ptr[kStatus]);
  io.ticks = static_cast<const int*>(ptr[kTicks]);
  io.steps = static_cast<const int*>(ptr[kSteps]);
  io.pshape = static_cast<const T*>(ptr[kPshape]);
  io.episode = static_cast<const int*>(ptr[kEpisode]);
  io.irx = static_cast<const T*>(ptr[kIrx]);
  io.motors = static_cast<const T*>(ptr[kMotors]);
  io.motor_sum = static_cast<const T*>(ptr[kMotorSum]);
  io.key = static_cast<const long long*>(ptr[kKey]);
  io.env_ids = static_cast<const int*>(ptr[kEnvIds]);
  io.x_out = static_cast<T*>(ptr[kXOut]);
  io.p_out = static_cast<T*>(ptr[kPOut]);
  io.status_out = static_cast<int*>(ptr[kStatusOut]);
  io.ticks_out = static_cast<int*>(ptr[kTicksOut]);
  io.steps_out = static_cast<int*>(ptr[kStepsOut]);
  io.pshape_out = static_cast<T*>(ptr[kPshapeOut]);
  io.episode_out = static_cast<int*>(ptr[kEpisodeOut]);
  io.irx_out = static_cast<T*>(ptr[kIrxOut]);
  io.obs = static_cast<T*>(ptr[kObs]);
  io.reward = static_cast<T*>(ptr[kReward]);
  io.done = static_cast<bool*>(ptr[kDone]);
  io.ts_status = static_cast<int*>(ptr[kTsStatus]);
  io.spinning = static_cast<bool*>(ptr[kSpinning]);
  io.ts_x = static_cast<T*>(ptr[kTsX]);
  return io;
}

// Instantiation I of the kernel: type I / (kinds * terminations) (float,
// double), then kind, then termination.
template <size_t I>
void launch_at(void* const* ptr, long long B, const Consts& c,
               cudaStream_t stream) {
  constexpr int kPerType = kNumKinds * kNumTerminations;
  constexpr int kind = static_cast<int>(I % kPerType) / kNumTerminations;
  constexpr int term = static_cast<int>(I % kNumTerminations);
  const unsigned blocks =
      static_cast<unsigned>((B + kThreads - 1) / kThreads);
  if constexpr (I / kPerType == 0) {
    env_step_kernel<kind, term, float><<<blocks, kThreads, 0, stream>>>(
        io_of<float>(ptr), B, c);
  } else {
    env_step_kernel<kind, term, double><<<blocks, kThreads, 0, stream>>>(
        io_of<double>(ptr), B, c);
  }
}

template <size_t... I>
constexpr std::array<Launch, sizeof...(I)> launch_table(
    std::index_sequence<I...>) {
  return {{&launch_at<I>...}};
}

constexpr auto kLaunch = launch_table(std::make_index_sequence<
    kNumTypes * kNumKinds * kNumTerminations>());

}  // namespace

// dtype: 0 float32, 1 float64; kind, termination: the indices above;
// ptrs: kNumPointers device pointers (enum Pointer), each tensor
// contiguous; fconsts, iconsts: struct Consts's doubles and ints in field
// order.
extern "C" int gct_env_step(int dtype, int kind, int termination,
                            void* const* ptrs, int n_ptrs, long long B,
                            const double* fconsts, int n_float,
                            const int* iconsts, int n_int, void* stream) {
  if (n_ptrs != kNumPointers || n_float != kNumFloat || n_int != kNumInt)
    return -1;
  static_assert(offsetof(Consts, max_steps) == kNumFloat * sizeof(double) &&
                    offsetof(Consts, obs11) ==
                        offsetof(Consts, max_steps) +
                            (kNumInt - 1) * sizeof(int),
                "Consts must hold exactly the double then the int constants");
  if (dtype < 0 || dtype >= kNumTypes || kind < 0 || kind >= kNumKinds ||
      termination < 0 || termination >= kNumTerminations)
    return -2;
  Consts c;
  memcpy(&c, fconsts, kNumFloat * sizeof(double));
  memcpy(reinterpret_cast<char*>(&c) + offsetof(Consts, max_steps), iconsts,
         kNumInt * sizeof(int));
  if (c.n_obs < 0 || c.n_obs > kMaxObs) return -1;
  if (B > 0)
    kLaunch[(dtype * kNumKinds + kind) * kNumTerminations + termination](
        ptrs, B, c, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gct_error_string(int code) {
  if (code == -1) return "pointer or constant arrays do not match the "
                         "kernel's";
  if (code == -2) return "no kernel instantiation for this type, kind and "
                         "termination";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
