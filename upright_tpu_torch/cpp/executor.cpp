// Real-time tracking executor: native runtime core of upright_tpu_torch.
//
// A copy of upright_tpu/cpp/executor.cpp (it has no accelerator code), built
// by upright_tpu_torch/runtime/native.py into upright_tpu_torch/build/.
// Equivalent of the reference's C++ runtime processes
// (upright_ros_interface/src/mrt_node.cpp, mpc_node.cpp): the accelerator
// solves MPC problems asynchronously while this executor tracks the latest
// policy at a hard real-time rate.  Replaces the ROS topic transport with
// lock-free single-producer/single-consumer seqlock buffers, and the ROS
// rate loop with absolute-deadline clock_nanosleep scheduling with overrun
// accounting (mrt_node.cpp:154,212-214: warn at 1.5x the loop period).
//
// Exposed as a plain C API consumed from Python via ctypes (no pybind11).
//
// Per tick (mrt_node.cpp:206-366):
//   1. read newest observation (q, v) from the observation buffer
//   2. Kalman filter predict/correct on [q, v, a] (triple integrator, jerk
//      input; mrt_node.cpp:156-237)
//   3. interpolate the newest policy, apply the LQR feedback gain
//   4. safety monitor: state limits with margins -> latch brake
//   5. double-integrate jerk into a velocity command, publish to the
//      command buffer

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// small dense linear algebra (sizes <= ~54; no external deps)
// ---------------------------------------------------------------------------

using Vec = std::vector<double>;
using Mat = std::vector<double>;  // row-major

inline double& at(Mat& M, int rows, int cols, int i, int j) {
    (void)rows;
    return M[i * cols + j];
}

void matmul(const Mat& A, const Mat& B, Mat& C, int n, int k, int m) {
    // C (n x m) = A (n x k) B (k x m)
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j < m; ++j) {
            double s = 0;
            for (int l = 0; l < k; ++l) s += A[i * k + l] * B[l * m + j];
            C[i * m + j] = s;
        }
    }
}

void matvec(const Mat& A, const Vec& x, Vec& y, int n, int m) {
    for (int i = 0; i < n; ++i) {
        double s = 0;
        for (int j = 0; j < m; ++j) s += A[i * m + j] * x[j];
        y[i] = s;
    }
}

// Solve S X = B in-place via Gauss-Jordan with partial pivoting.
// S: (n x n), B: (n x m); X overwrites B.  Returns false if singular.
bool solve_inplace(Mat S, Mat& B, int n, int m) {
    for (int col = 0; col < n; ++col) {
        int piv = col;
        double best = std::fabs(S[col * n + col]);
        for (int r = col + 1; r < n; ++r) {
            double v = std::fabs(S[r * n + col]);
            if (v > best) {
                best = v;
                piv = r;
            }
        }
        if (best < 1e-12) return false;
        if (piv != col) {
            for (int j = 0; j < n; ++j) std::swap(S[col * n + j], S[piv * n + j]);
            for (int j = 0; j < m; ++j) std::swap(B[col * m + j], B[piv * m + j]);
        }
        const double d = S[col * n + col];
        for (int j = 0; j < n; ++j) S[col * n + j] /= d;
        for (int j = 0; j < m; ++j) B[col * m + j] /= d;
        for (int r = 0; r < n; ++r) {
            if (r == col) continue;
            const double f = S[r * n + col];
            if (f == 0) continue;
            for (int j = 0; j < n; ++j) S[r * n + j] -= f * S[col * n + j];
            for (int j = 0; j < m; ++j) B[r * m + j] -= f * B[col * m + j];
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// seqlock SPSC buffers (replaces the ROS observation/policy topics)
// ---------------------------------------------------------------------------

struct Seqlock {
    std::atomic<uint64_t> seq{0};

    template <typename F>
    void write(F&& fill) {
        const uint64_t s = seq.load(std::memory_order_relaxed);
        seq.store(s + 1, std::memory_order_relaxed);  // odd: write in progress
        // order the data writes in fill() after the odd store
        std::atomic_thread_fence(std::memory_order_release);
        fill();
        // release store orders the data writes before the even store
        seq.store(s + 2, std::memory_order_release);
    }

    template <typename F>
    bool read(F&& copy) const {
        for (int attempt = 0; attempt < 8; ++attempt) {
            const uint64_t s0 = seq.load(std::memory_order_acquire);
            if (s0 & 1) continue;
            copy();
            // order the data reads in copy() before the re-read of seq
            std::atomic_thread_fence(std::memory_order_acquire);
            const uint64_t s1 = seq.load(std::memory_order_relaxed);
            if (s0 == s1) return s0 != 0;
        }
        return false;
    }
};

struct Observation {
    double t = 0;       // caller (plant) timestamp
    double wall = 0;    // CLOCK_MONOTONIC at post time (clock slaving)
    Vec q, v;  // preallocated at create; only memcpy'd afterwards
};

// Fixed-capacity policy storage.  The backing vectors are sized ONCE at
// create time and never resized afterwards, so concurrent reader memcpys can
// never chase a reallocated data pointer; a seqlock per slot detects torn
// copies and the two slots are alternated by the writer so the slot a reader
// is copying from is not the one being overwritten by the next post.
struct Policy {
    double t0 = 0;
    double dt = 0.1;
    int N = 0;
    Mat X;  // capacity (max_N+1, nx), valid rows N+1
    Mat U;  // capacity (max_N, nq), valid rows N
    Mat K;  // capacity (max_N, nq, nx), valid rows N

    void alloc(int max_N, int nx, int nq) {
        X.assign((size_t)(max_N + 1) * nx, 0.0);
        U.assign((size_t)max_N * nq, 0.0);
        K.assign((size_t)max_N * nq * nx, 0.0);
    }
};

// ---------------------------------------------------------------------------
// Kalman filter on [q, v, a] with jerk input (triple integrator)
// ---------------------------------------------------------------------------

struct TrackerKF {
    int nq = 0, nx = 0, ny = 0;
    double dt = 0;
    Vec x;   // state [q, v, a]
    Mat P;   // covariance (nx x nx)
    double q_proc = 10.0, r_meas = 1e-3;

    void init(int nq_, double dt_, double p0, double qp, double rm, const double* x0) {
        nq = nq_;
        nx = 3 * nq;
        ny = 2 * nq;
        dt = dt_;
        q_proc = qp;
        r_meas = rm;
        x.assign(nx, 0.0);
        if (x0) std::memcpy(x.data(), x0, nx * sizeof(double));
        P.assign(nx * nx, 0.0);
        for (int i = 0; i < nx; ++i) P[i * nx + i] = p0;
    }

    // x' = A x + B u with the exact triple-integrator transition
    void predict(const Vec& u) {
        Vec xn(nx);
        const double h = dt, h2 = 0.5 * dt * dt, h3 = dt * dt * dt / 6.0;
        for (int i = 0; i < nq; ++i) {
            const double qi = x[i], vi = x[nq + i], ai = x[2 * nq + i], ji = u[i];
            xn[i] = qi + h * vi + h2 * ai + h3 * ji;
            xn[nq + i] = vi + h * ai + h2 * ji;
            xn[2 * nq + i] = ai + h * ji;
        }
        x = xn;
        // P' = A P A^T + Q with structured A (block upper-triangular)
        Mat A(nx * nx, 0.0);
        for (int i = 0; i < nq; ++i) {
            A[i * nx + i] = 1;
            A[i * nx + nq + i] = h;
            A[i * nx + 2 * nq + i] = h2;
            A[(nq + i) * nx + nq + i] = 1;
            A[(nq + i) * nx + 2 * nq + i] = h;
            A[(2 * nq + i) * nx + 2 * nq + i] = 1;
        }
        Mat AP(nx * nx), APA(nx * nx);
        matmul(A, P, AP, nx, nx, nx);
        // APA = AP A^T
        for (int i = 0; i < nx; ++i)
            for (int j = 0; j < nx; ++j) {
                double s = 0;
                for (int l = 0; l < nx; ++l) s += AP[i * nx + l] * A[j * nx + l];
                APA[i * nx + j] = s;
            }
        P = APA;
        for (int i = 0; i < nx; ++i) P[i * nx + i] += q_proc;
    }

    // measurement y = [q, v]
    void correct(const Vec& y) {
        // S = H P H^T + R  with H = [I_{2nq} 0]
        Mat S(ny * ny);
        for (int i = 0; i < ny; ++i)
            for (int j = 0; j < ny; ++j) S[i * ny + j] = P[i * nx + j];
        for (int i = 0; i < ny; ++i) S[i * ny + i] += r_meas;
        // K = P H^T S^{-1}: solve S^T K^T = (P H^T)^T => use symmetry of S
        Mat PHt(nx * ny);
        for (int i = 0; i < nx; ++i)
            for (int j = 0; j < ny; ++j) PHt[i * ny + j] = P[i * nx + j];
        // X = S^{-1} (PHt)^T  -> K = X^T
        Mat Bt(ny * nx);
        for (int i = 0; i < ny; ++i)
            for (int j = 0; j < nx; ++j) Bt[i * nx + j] = PHt[j * ny + i];
        if (!solve_inplace(S, Bt, ny, nx)) return;
        // x += K e
        Vec e(ny);
        for (int i = 0; i < ny; ++i) e[i] = y[i] - x[i];
        for (int i = 0; i < nx; ++i) {
            double s = 0;
            for (int j = 0; j < ny; ++j) s += Bt[j * nx + i] * e[j];
            x[i] += s;
        }
        // P = (I - K H) P ; K H = K over first ny columns
        Mat Pn(nx * nx);
        for (int i = 0; i < nx; ++i)
            for (int j = 0; j < nx; ++j) {
                double s = P[i * nx + j];
                for (int l = 0; l < ny; ++l) s -= Bt[l * nx + i] * P[l * nx + j];
                Pn[i * nx + j] = s;
            }
        P = Pn;
    }
};

// ---------------------------------------------------------------------------
// the executor
// ---------------------------------------------------------------------------

struct Executor {
    int nq = 0, nx = 0;
    double rate = 125.0;
    double period = 0.008;

    // limits + margins (safety.h:15-103)
    Vec state_lb, state_ub;
    double state_margin = 0.1;
    bool enforce_state = false;

    TrackerKF kf;

    static constexpr int kMaxPolicyN = 512;  // horizon capacity (N <= 512)

    Seqlock obs_lock, cmd_lock;
    Observation obs_buf;
    // double-buffered policy: writer alternates slots, publishes via pol_cur
    Seqlock pol_slot_lock[2];
    Policy pol_slot[2];
    std::atomic<int> pol_cur{-1};
    Vec cmd_buf;
    double cmd_time = 0;
    double last_tick_time = -1;  // caller time of the previous tick (KF step)
    double last_obs_time = -1e300;  // timestamp of the last CORRECTED obs

    std::atomic<bool> running{false};
    std::atomic<bool> braked{false};
    double time_offset = 0;  // maps CLOCK_MONOTONIC to the caller's clock
    // slow-motion factor: caller (sim) seconds per wall second.  The loop
    // still ticks at `rate` Hz wall, but policy-evaluation time, the KF
    // step, and the command integration horizon all advance in scaled
    // (caller) time, so the executor stays consistent with a plant that
    // cannot run real time (a plant that shares its host with the planner).
    double time_scale = 1.0;
    std::atomic<uint64_t> ticks{0};
    std::atomic<uint64_t> overruns{0};
    std::atomic<uint64_t> policy_switches{0};
    double max_tick_seconds = 0;

    Vec last_u;
    std::thread thread;

    // scratch policy copy for the tracker thread
    Policy pol_local;
    double pol_local_t0 = -1;

    void tick(double t_now, bool slave_to_obs = false) {
        // 1. observation
        Observation o;
        o.q.resize(nq);
        o.v.resize(nq);
        bool have_obs = obs_lock.read([&] {
            o.t = obs_buf.t;
            o.wall = obs_buf.wall;
            std::memcpy(o.q.data(), obs_buf.q.data(), nq * sizeof(double));
            std::memcpy(o.v.data(), obs_buf.v.data(), nq * sizeof(double));
        });
        if (!have_obs) return;

        // Clock slaving: on the threaded loop the policy-evaluation time is
        // extrapolated from the PLANT's latest timestamp rather than mapped
        // from the wall clock, so a plant that falls behind real time (a
        // CPU-hosted sim contending with the planner) cannot accumulate a
        // phase error between the policy query time and the plant state —
        // drift is bounded by one observation interval.  On real hardware
        // observations arrive at wall rate and this reduces to the wall
        // clock with jitter <= one interval (t_now is the raw monotonic
        // time in that mode; `o.wall` was stamped with the same clock).
        if (slave_to_obs) t_now = o.t + time_scale * (t_now - o.wall);

        // KF step = the ACTUAL caller-time elapsed since the previous tick
        // (clamped).  A fixed per-tick step would integrate the state at the
        // tick rate even when the plant's clock advances slower than the
        // wall (sim hosts), over-propagating the estimate.
        double h = t_now - last_tick_time;
        const double h_nom = period * time_scale;
        if (last_tick_time < 0 || h < 0) h = h_nom;
        if (h > 4 * h_nom) h = 4 * h_nom;
        last_tick_time = t_now;
        kf.dt = h;

        // 2. KF: predict every tick, correct ONCE per NEW measurement.
        // When several ticks elapse per observation (slow-motion sim hosts,
        // or a real sensor slower than the loop) re-correcting with the
        // same stale sample drags the estimate back toward the old state
        // each tick and destabilizes the tracking feedback.
        kf.predict(last_u);
        if (o.t != last_obs_time) {
            last_obs_time = o.t;
            Vec y(2 * nq);
            std::memcpy(y.data(), o.q.data(), nq * sizeof(double));
            std::memcpy(y.data() + nq, o.v.data(), nq * sizeof(double));
            kf.correct(y);
        }

        // 3. policy (copy the published slot into preallocated local storage;
        // the slot seqlock rejects torn copies if the writer laps the reader)
        const int cur = pol_cur.load(std::memory_order_acquire);
        bool have_pol = false;
        if (cur >= 0) {
            const Policy& src = pol_slot[cur];
            have_pol = pol_slot_lock[cur].read([&] {
                if (pol_local_t0 != src.t0) {
                    pol_local.t0 = src.t0;
                    pol_local.dt = src.dt;
                    pol_local.N = src.N;
                    const int n = src.N;
                    std::memcpy(pol_local.X.data(), src.X.data(),
                                (size_t)(n + 1) * nx * sizeof(double));
                    std::memcpy(pol_local.U.data(), src.U.data(),
                                (size_t)n * nq * sizeof(double));
                    std::memcpy(pol_local.K.data(), src.K.data(),
                                (size_t)n * nq * nx * sizeof(double));
                    pol_local_t0 = src.t0;
                    policy_switches.fetch_add(1, std::memory_order_relaxed);
                }
            });
            if (!have_pol) pol_local_t0 = -1;  // torn copy: retry next tick
        }
        if (!have_pol || pol_local.N == 0) return;

        const Policy& P = pol_local;
        double tau = (t_now - P.t0) / P.dt;
        int k = (int)std::floor(tau);
        if (k < 0) k = 0;
        if (k > P.N - 1) k = P.N - 1;
        double alpha = tau - k;
        if (alpha < 0) alpha = 0;
        if (alpha > 1) alpha = 1;

        // xd = (1-alpha) X[k] + alpha X[k+1]; u = U[k] + K[k] (x - X[k])
        Vec u(nq);
        for (int i = 0; i < nq; ++i) u[i] = P.U[k * nq + i];
        const double* Xk = &P.X[k * nx];
        for (int i = 0; i < nq; ++i) {
            double s = 0;
            const double* Krow = &P.K[(k * nq + i) * nx];
            for (int j = 0; j < nx; ++j) s += Krow[j] * (kf.x[j] - Xk[j]);
            u[i] += s;
        }

        // 4. safety (state limits with margin)
        if (enforce_state && !state_lb.empty()) {
            for (int i = 0; i < nx; ++i) {
                if (kf.x[i] < state_lb[i] - state_margin ||
                    kf.x[i] > state_ub[i] + state_margin) {
                    braked.store(true, std::memory_order_release);
                    break;
                }
            }
        }

        // 5. command
        Vec v_cmd(nq, 0.0);
        if (!braked.load(std::memory_order_acquire)) {
            const double hp = period * time_scale;  // caller-time tick period
            for (int i = 0; i < nq; ++i) {
                const double v = kf.x[nq + i], a = kf.x[2 * nq + i];
                v_cmd[i] = v + hp * a + 0.5 * hp * hp * u[i];
            }
            last_u = u;
        } else {
            std::fill(last_u.begin(), last_u.end(), 0.0);
        }
        cmd_lock.write([&] {
            std::memcpy(cmd_buf.data(), v_cmd.data(), nq * sizeof(double));
            cmd_time = t_now;
        });
    }

    static double now_seconds() {
        struct timespec ts;
        clock_gettime(CLOCK_MONOTONIC, &ts);
        return ts.tv_sec + 1e-9 * ts.tv_nsec;
    }

    void run() {
        struct timespec next;
        clock_gettime(CLOCK_MONOTONIC, &next);
        const long period_ns = (long)(period * 1e9);
        while (running.load(std::memory_order_acquire)) {
            const double t0 = now_seconds();
            tick(t0, /*slave_to_obs=*/true);
            const double elapsed = now_seconds() - t0;
            if (elapsed > max_tick_seconds) max_tick_seconds = elapsed;
            if (elapsed > 1.5 * period)  // mrt_node.cpp:212-214
                overruns.fetch_add(1, std::memory_order_relaxed);
            ticks.fetch_add(1, std::memory_order_relaxed);

            next.tv_nsec += period_ns;
            while (next.tv_nsec >= 1000000000L) {
                next.tv_nsec -= 1000000000L;
                next.tv_sec += 1;
            }
            clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next, nullptr);
        }
    }
};

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

void* upright_executor_create(int nq, double rate, double kf_init_var,
                              double kf_proc_var, double kf_meas_var,
                              const double* x0) {
    auto* ex = new Executor();
    ex->nq = nq;
    ex->nx = 3 * nq;
    ex->rate = rate;
    ex->period = 1.0 / rate;
    ex->kf.init(nq, ex->period, kf_init_var, kf_proc_var, kf_meas_var, x0);
    ex->last_u.assign(nq, 0.0);
    ex->cmd_buf.assign(nq, 0.0);
    ex->obs_buf.q.assign(nq, 0.0);
    ex->obs_buf.v.assign(nq, 0.0);
    // preallocate fixed-capacity policy storage (never resized afterwards)
    ex->pol_slot[0].alloc(Executor::kMaxPolicyN, ex->nx, nq);
    ex->pol_slot[1].alloc(Executor::kMaxPolicyN, ex->nx, nq);
    ex->pol_local.alloc(Executor::kMaxPolicyN, ex->nx, nq);
    return ex;
}

void upright_executor_set_state_limits(void* h, const double* lb,
                                       const double* ub, double margin) {
    auto* ex = static_cast<Executor*>(h);
    ex->state_lb.assign(lb, lb + ex->nx);
    ex->state_ub.assign(ub, ub + ex->nx);
    ex->state_margin = margin;
    ex->enforce_state = true;
}

void upright_executor_post_observation(void* h, double t, const double* q,
                                       const double* v) {
    auto* ex = static_cast<Executor*>(h);
    const double wall = Executor::now_seconds();
    ex->obs_lock.write([&] {
        ex->obs_buf.t = t;
        ex->obs_buf.wall = wall;
        std::memcpy(ex->obs_buf.q.data(), q, ex->nq * sizeof(double));
        std::memcpy(ex->obs_buf.v.data(), v, ex->nq * sizeof(double));
    });
}

int upright_executor_post_policy(void* h, double t0, double dt, int N,
                                 const double* X, const double* U,
                                 const double* K) {
    auto* ex = static_cast<Executor*>(h);
    const int nx = ex->nx, nq = ex->nq;
    if (N > Executor::kMaxPolicyN) return 0;  // exceeds fixed buffer capacity
    const int cur = ex->pol_cur.load(std::memory_order_relaxed);
    const int w = cur == 0 ? 1 : 0;  // write the slot not being read
    Policy& dst = ex->pol_slot[w];
    ex->pol_slot_lock[w].write([&] {
        dst.t0 = t0;
        dst.dt = dt;
        dst.N = N;
        std::memcpy(dst.X.data(), X, (size_t)(N + 1) * nx * sizeof(double));
        std::memcpy(dst.U.data(), U, (size_t)N * nq * sizeof(double));
        std::memcpy(dst.K.data(), K, (size_t)N * nq * nx * sizeof(double));
    });
    ex->pol_cur.store(w, std::memory_order_release);
    return 1;
}

int upright_executor_get_command(void* h, double* v_cmd, double* t_cmd) {
    auto* ex = static_cast<Executor*>(h);
    bool ok = ex->cmd_lock.read([&] {
        std::memcpy(v_cmd, ex->cmd_buf.data(), ex->nq * sizeof(double));
        *t_cmd = ex->cmd_time;
    });
    return ok ? 1 : 0;
}

void upright_executor_get_state_estimate(void* h, double* x) {
    auto* ex = static_cast<Executor*>(h);
    std::memcpy(x, ex->kf.x.data(), ex->nx * sizeof(double));
}

void upright_executor_start(void* h) {
    auto* ex = static_cast<Executor*>(h);
    bool expected = false;
    if (ex->running.compare_exchange_strong(expected, true))
        ex->thread = std::thread([ex] { ex->run(); });
}

void upright_executor_start_at(void* h, double t_now) {
    // align the executor's clock: monotonic 'now' corresponds to t_now on the
    // caller's timeline (policies/observations are stamped in that timeline)
    auto* ex = static_cast<Executor*>(h);
    ex->time_offset = t_now - ex->time_scale * Executor::now_seconds();
    upright_executor_start(h);
}

void upright_executor_set_time_scale(void* h, double scale) {
    // slow-motion: caller (sim) seconds per wall second.  Must be set before
    // start; rescales the KF step to the caller-time tick period so state
    // propagation matches the plant's timeline.
    auto* ex = static_cast<Executor*>(h);
    ex->time_scale = scale;
    ex->kf.dt = ex->period * scale;
}

void upright_executor_stop(void* h) {
    auto* ex = static_cast<Executor*>(h);
    ex->running.store(false, std::memory_order_release);
    if (ex->thread.joinable()) ex->thread.join();
}

void upright_executor_tick(void* h, double t) {
    // explicit single tick (testing / sim-time stepping without the thread)
    static_cast<Executor*>(h)->tick(t);
}

int upright_executor_braked(void* h) {
    return static_cast<Executor*>(h)->braked.load() ? 1 : 0;
}

void upright_executor_stats(void* h, double* out4) {
    auto* ex = static_cast<Executor*>(h);
    out4[0] = (double)ex->ticks.load();
    out4[1] = (double)ex->overruns.load();
    out4[2] = (double)ex->policy_switches.load();
    out4[3] = ex->max_tick_seconds;
}

void upright_executor_destroy(void* h) {
    auto* ex = static_cast<Executor*>(h);
    upright_executor_stop(ex);
    delete ex;
}

}  // extern "C"
