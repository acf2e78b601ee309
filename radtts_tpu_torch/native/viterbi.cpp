// Dense log-space Viterbi decoder for the pYIN pitch HMM: a copy of the JAX
// package's radtts_tpu/native/viterbi.cpp for the port's data pipeline.
//
// Exact drop-in for radtts_tpu_torch.data.pyin._viterbi_log (same operation
// order: for each next-state j, argmax over predecessors k of
// delta[k] + log_trans[k*S + j], first-index tie-breaking like
// numpy.argmax). The reference's pipeline runs librosa's numba pyin on CPU
// dataloader workers (reference: data.py:244-256); this is the TPU
// framework's native-code equivalent for that preprocessing hot path
// (~12x faster than the numpy loop at S=722, T=733).
//
// Build: g++ -O3 -shared -fPIC -o libviterbi.so viterbi.cpp
// (done automatically, into build/radtts_tpu_torch/, by
// radtts_tpu_torch/native/__init__.py)

#include <cstdint>
#include <vector>

extern "C" {

// log_obs: (T, S) row-major; log_trans: (S, S) row-major;
// log_p_init: (S,); states_out: (T,)
void viterbi_log(const double* log_obs, const double* log_trans,
                 const double* log_p_init, int64_t T, int64_t S,
                 int32_t* states_out, int32_t* psi_workspace) {
    std::vector<double> delta(S), best(S);
    std::vector<int32_t> arg(S);

    for (int64_t j = 0; j < S; ++j)
        delta[j] = log_p_init[j] + log_obs[j];

    double* __restrict bestp = best.data();
    int32_t* __restrict argp = arg.data();
    for (int64_t t = 1; t < T; ++t) {
        // best[j] = max_k delta[k] + log_trans[k, j]; first max wins
        const double* row0 = log_trans;
        for (int64_t j = 0; j < S; ++j) {
            bestp[j] = delta[0] + row0[j];
            argp[j] = 0;
        }
        for (int64_t k = 1; k < S; ++k) {
            const double dk = delta[k];
            const double* __restrict row = log_trans + k * S;
            // branchless select so the compiler vectorizes (AVX cmp+blend);
            // strict > keeps the first (lowest) k, like numpy argmax
            for (int64_t j = 0; j < S; ++j) {
                const double s = dk + row[j];
                const bool m = s > bestp[j];
                bestp[j] = m ? s : bestp[j];
                argp[j] = m ? (int32_t)k : argp[j];
            }
        }
        const double* obs = log_obs + t * S;
        int32_t* psi_t = psi_workspace + t * S;
        for (int64_t j = 0; j < S; ++j) {
            delta[j] = best[j] + obs[j];
            psi_t[j] = arg[j];
        }
    }

    // argmax of final delta (first max wins, like numpy)
    int32_t last = 0;
    double m = delta[0];
    for (int64_t j = 1; j < S; ++j)
        if (delta[j] > m) { m = delta[j]; last = (int32_t)j; }
    states_out[T - 1] = last;
    for (int64_t t = T - 2; t >= 0; --t)
        states_out[t] = psi_workspace[(t + 1) * S + states_out[t + 1]];
}

// Banded-structure Viterbi for the pYIN pitch HMM specifically.
//
// pyin's transition matrix is kron([[1-p, p], [p, 1-p]], L) with L a
// row-normalized triangular band of half-width `half` (width 51 at the
// default max_transition_rate), and every out-of-band entry is EXACTLY
// log(eps) (`voob`) because np.log(0 + eps) is the same double everywhere.
// The Python wrapper verifies this structure by equality before
// dispatching here; anything else falls back to the dense kernel above.
//
// EXACT same results as the dense kernel (global first-index argmax over
// all S predecessors), computed as:
//   pass 1: in-band cells only, row-major sweep (same select idiom as the
//           dense kernel, ~S*(4*half+4) cells instead of S^2);
//   pass 2: the out-of-band best for column (b', c') is
//           max(delta[k]) + voob over the complement
//           [0,a) U (b, N+a) U (N+b, S), a=max(0,c'-half),
//           b=min(N-1,c'+half) — prefix/suffix max arrays for the outer
//           intervals and a monotonic deque (sliding-window max) for the
//           middle one; merged with first-k tie-breaking.
void viterbi_log_banded(const double* log_obs, const double* log_trans,
                        const double* log_p_init, int64_t T, int64_t N,
                        int64_t half, double voob,
                        int32_t* states_out, int32_t* psi_workspace) {
    const int64_t S = 2 * N;
    std::vector<double> delta(S), best(S);
    std::vector<int32_t> arg(S);
    std::vector<double> pre_val(S), suf_val(S);
    std::vector<int32_t> pre_idx(S), suf_idx(S);
    std::vector<int64_t> dq_k(S);
    std::vector<double> dq_v(S);

    for (int64_t j = 0; j < S; ++j)
        delta[j] = log_p_init[j] + log_obs[j];

    double* __restrict bestp = best.data();
    int32_t* __restrict argp = arg.data();
    const double NEG_INF = -1.0 / 0.0;

    for (int64_t t = 1; t < T; ++t) {
        // prefix/suffix max of delta, first index wins ties
        pre_val[0] = delta[0]; pre_idx[0] = 0;
        for (int64_t k = 1; k < S; ++k) {
            if (delta[k] > pre_val[k - 1]) {
                pre_val[k] = delta[k]; pre_idx[k] = (int32_t)k;
            } else {
                pre_val[k] = pre_val[k - 1]; pre_idx[k] = pre_idx[k - 1];
            }
        }
        suf_val[S - 1] = delta[S - 1]; suf_idx[S - 1] = (int32_t)(S - 1);
        for (int64_t k = S - 2; k >= 0; --k) {
            if (delta[k] >= suf_val[k + 1]) {  // >= keeps the LOWER index
                suf_val[k] = delta[k]; suf_idx[k] = (int32_t)k;
            } else {
                suf_val[k] = suf_val[k + 1]; suf_idx[k] = suf_idx[k + 1];
            }
        }

        // pass 1: in-band cells, ascending k so strict > = first argmax
        for (int64_t j = 0; j < S; ++j) { bestp[j] = NEG_INF; argp[j] = 0; }
        for (int64_t k = 0; k < S; ++k) {
            const int64_t c = k < N ? k : k - N;
            const double dk = delta[k];
            const double* __restrict row = log_trans + k * S;
            const int64_t lo = c > half ? c - half : 0;
            const int64_t hi = c + half + 1 < N ? c + half + 1 : N;
            for (int64_t b2 = 0; b2 < 2; ++b2) {
                const int64_t off = b2 * N;
                for (int64_t j = off + lo; j < off + hi; ++j) {
                    const double s = dk + row[j];
                    const bool m = s > bestp[j];
                    bestp[j] = m ? s : bestp[j];
                    argp[j] = m ? (int32_t)k : argp[j];
                }
            }
        }

        // pass 2: out-of-band merge, one sweep over c'
        int64_t head = 0, tail = 0;
        int64_t pushed = half + 1 < N ? half + 1 : N;  // b(0)+1
        for (int64_t k = pushed; k < N; ++k) {  // initial window [b+1, N)
            while (tail > head && dq_v[tail - 1] < delta[k]) --tail;
            dq_k[tail] = k; dq_v[tail] = delta[k]; ++tail;
        }
        pushed = N;
        for (int64_t c2 = 0; c2 < N; ++c2) {
            const int64_t a = c2 > half ? c2 - half : 0;
            const int64_t b = c2 + half < N - 1 ? c2 + half : N - 1;
            // window [b+1, N+a): extend right, shrink left
            for (; pushed < N + a; ++pushed) {
                while (tail > head && dq_v[tail - 1] < delta[pushed])
                    --tail;
                dq_k[tail] = pushed; dq_v[tail] = delta[pushed]; ++tail;
            }
            while (head < tail && dq_k[head] <= b) ++head;

            // first-max over the three k-ordered complement intervals
            double ov = NEG_INF; int32_t ok = 0; bool have = false;
            if (a > 0) { ov = pre_val[a - 1]; ok = pre_idx[a - 1];
                         have = true; }
            if (head < tail && (!have || dq_v[head] > ov)) {
                ov = dq_v[head]; ok = (int32_t)dq_k[head]; have = true;
            }
            if (N + b + 1 < S && (!have || suf_val[N + b + 1] > ov)) {
                ov = suf_val[N + b + 1]; ok = suf_idx[N + b + 1];
                have = true;
            }
            if (!have) continue;  // full-width band: no out-of-band ks
            const double oob = ov + voob;
            for (int64_t b2 = 0; b2 < 2; ++b2) {
                const int64_t j = b2 * N + c2;
                if (oob > bestp[j]
                    || (oob == bestp[j] && ok < argp[j])) {
                    bestp[j] = oob; argp[j] = ok;
                }
            }
        }

        const double* obs = log_obs + t * S;
        int32_t* psi_t = psi_workspace + t * S;
        for (int64_t j = 0; j < S; ++j) {
            delta[j] = bestp[j] + obs[j];
            psi_t[j] = argp[j];
        }
    }

    int32_t last = 0;
    double m = delta[0];
    for (int64_t j = 1; j < S; ++j)
        if (delta[j] > m) { m = delta[j]; last = (int32_t)j; }
    states_out[T - 1] = last;
    for (int64_t t = T - 2; t >= 0; --t)
        states_out[t] = psi_workspace[(t + 1) * S + states_out[t + 1]];
}

}  // extern "C"
