"""The E-value statistics, a frozen copy of `oswald_tpu_torch.stats`
(`ScoreStats.tail_p`/`evalues`, `fit_score_model`, `tail_calibrate`): a
length-regressed Gumbel fit from the score moments, recalibrated on two
tail counts.  The reference feeds it the moments of its own scores; the
port's own module is what is judged.
"""

import dataclasses
import math

import numpy as np

_GAMMA = 0.5772156649015329          # Euler-Mascheroni
_MIN_FIT_N = 50                      # fewer sequences: no meaningful fit


@dataclasses.dataclass
class ScoreStats:
    """Fitted null-score model for one (query, database) search."""
    n_fit: int          # sequences in the fit (top-k hits excluded)
    mean: float         # mean score over the fit set
    var: float          # RESIDUAL score variance (after the lnL trend)
    lam: float          # Gumbel rate (lambda) of the residuals
    a: float            # regression intercept
    b: float            # score-vs-ln(subject length) slope
    mu: float           # pooled Gumbel location (= location at the mean
                        # lnL); used when subject lengths are unknown

    def _loc(self, lnl):
        """Gumbel location parameter for subjects of ln-length lnl."""
        return self.a + self.b * lnl - _GAMMA / self.lam

    def tail_p(self, scores, lnl=None) -> np.ndarray:
        """Per-sequence P(S >= s) under the fitted null; lnl (ln subject
        length, broadcastable) selects the length-conditional null, else
        the pooled location is used."""
        s = np.asarray(scores, np.float64)
        loc = self.mu if lnl is None else self._loc(np.asarray(lnl))
        return -np.expm1(-np.exp(np.minimum(-self.lam * (s - loc), 30.0)))

    def evalues(self, scores, n_db: int, len_hist=None) -> np.ndarray:
        """Expected chance hits >= s across the database.

        len_hist: optional (unique_lengths, counts) of the database's true
        sequence lengths — integrates the tail over the length spectrum
        (unique protein lengths number in the thousands, so this is O(k *
        n_unique), independent of database size).  Without it the pooled
        location is used for all n_db sequences."""
        s = np.asarray(scores, np.float64)
        if len_hist is None:
            return n_db * self.tail_p(s)
        uniq, counts = len_hist
        lnl = np.log(np.maximum(np.asarray(uniq, np.float64), 1.0))
        p = self.tail_p(s[:, None], lnl[None, :])        # [k, n_unique]
        return p @ np.asarray(counts, np.float64)


def fit_score_model(n_valid: int, s1: float, s2: float, s_lnl: float,
                    lnl1: float, lnl2: float,
                    exclude_scores=None, exclude_lnl=None):
    """Length-regressed extreme-value fit from streaming moments.

    n_valid, s1, s2, s_lnl: count, sum(S), sum(S^2), sum(S*lnL) over every
    real database sequence's score (device-accumulated).  lnl1, lnl2:
    sum(lnL), sum(lnL^2) — static per database.  exclude_scores /
    exclude_lnl: the reported hits' scores and ln-lengths, removed from
    every moment.  Returns ScoreStats or None (too few sequences, or
    degenerate residual variance)."""
    n = int(n_valid)
    s1, s2, s_lnl = float(s1), float(s2), float(s_lnl)
    lnl1, lnl2 = float(lnl1), float(lnl2)
    if exclude_scores is not None and len(exclude_scores):
        ex = np.asarray(exclude_scores, np.float64)
        exl = np.asarray(exclude_lnl, np.float64)
        n -= ex.size
        s1 -= float(ex.sum())
        s2 -= float((ex * ex).sum())
        s_lnl -= float((ex * exl).sum())
        lnl1 -= float(exl.sum())
        lnl2 -= float((exl * exl).sum())
    if n < _MIN_FIT_N:
        return None
    mean_s = s1 / n
    mean_l = lnl1 / n
    var_s = max(s2 / n - mean_s * mean_s, 0.0)
    var_l = max(lnl2 / n - mean_l * mean_l, 0.0)
    cov = s_lnl / n - mean_s * mean_l
    # single distinct length (or numerically so): pooled fit, slope 0
    b = cov / var_l if var_l > 1e-12 else 0.0
    var_resid = max(var_s - b * cov, 0.0) if b else var_s
    if var_resid <= 0.0:
        return None
    a = mean_s - b * mean_l
    lam = math.pi / math.sqrt(6.0 * var_resid)
    mu = mean_s - _GAMMA / lam               # pooled location
    return ScoreStats(n_fit=n, mean=mean_s, var=var_resid, lam=lam,
                      a=a, b=b, mu=mu)


def tail_calibrate(st: ScoreStats | None, n_db: int, len_hist, T0, T1,
                   c0, c1, exclude_scores=None,
                   min_tail: int = 15) -> ScoreStats | None:
    """Right-tail recalibration of a moment-fitted null.

    The method-of-moments lambda is variance-matched, and gapped-SW score
    distributions have a slightly heavier right tail than a variance-
    matched Gumbel (measured: empirical tail counts exceed the MoM model
    by a factor growing from ~1.1 at the median to ~1.4 at the 99.9th
    percentile — reported E-values ran ~2x anti-conservative).  The
    device therefore also streams TWO tail exceedance counts, c0 at
    T0 ~ mean + 1.2 sd and c1 at T1 ~ mean + 2.5 sd (thresholds from the
    hit-excluded mean/sd, so a planted homolog cannot inflate them).
    Both live in the exponential tail, so their ratio identifies the rate
    directly:

        lambda = ln(c0 / c1) / (T1 - T0)

    The reported hits must come out of the counts (a true positive is
    not chance): each excluded hit >= T is subtracted, and the chance
    mass ABOVE the smallest excluded hit s_k — removed along with the
    hits — is restored by the model's own tail factor
    F(T) = 1 - exp(-lambda (s_k - T)), iterated to a fixed point (two
    or three iterations; lambda appears only inside F).  The length
    trend (a, b) is kept from the regression; the location is then
    re-anchored so the modeled expected count at T1 equals the corrected
    observed chance count — a direct calibration of E(T1) against data.
    Falls back to the MoM fit when the tail is too thin (corrected
    c1 < min_tail) or degenerate — small databases keep the
    moment-only fit."""
    if st is None or T1 is None:
        return st
    # small databases: the integer thresholds sit a handful of score
    # levels apart and the count ratio is noise (measured: a 700-seq db
    # produced lambda estimates 4x off); the MoM fit is the honest model
    # there, and keeping it below the floor also keeps single/dist/batch
    # paths (some of which cannot stream tail counts) in agreement on
    # every CI-sized database
    if st.n_fit < 2000:
        return st
    T0, T1, c0, c1 = float(T0), float(T1), float(c0), float(c1)
    if T1 < 0 or T1 - T0 < 3:       # sentinel / degenerate spread
        return st
    ex = np.asarray(exclude_scores, np.float64) \
        if exclude_scores is not None and len(exclude_scores) else \
        np.zeros(0, np.float64)
    ex = ex[ex >= 0]
    h0 = float((ex >= T0).sum())
    h1 = float((ex >= T1).sum())
    s_k = float(ex.min()) if ex.size else float("inf")
    lam_t = st.lam
    for _ in range(6):
        def chance(T, c_raw, h):
            if not math.isfinite(s_k) or s_k <= T:
                # no hits at all (tail unobstructed), or every removed
                # hit sits below T (nothing to restore)
                return c_raw - h
            f = -math.expm1(-lam_t * (s_k - T))
            return (c_raw - h) / max(f, 1e-9)
        cc0, cc1 = chance(T0, c0, h0), chance(T1, c1, h1)
        if cc1 < min_tail or cc0 <= cc1:
            return st
        lam_new = math.log(cc0 / cc1) / (T1 - T0)
        # the genuine heavy-tail correction is 5-20%; a rate far from the
        # variance-matched one is estimator noise, so clamp — the count
        # ANCHOR below still calibrates the absolute level either way
        lam_new = min(max(lam_new, st.lam / 1.5), st.lam * 1.5)
        if abs(lam_new - lam_t) < 1e-6:
            lam_t = lam_new
            break
        lam_t = lam_new
    # keep (a, b); re-anchor so E_model(T1) == corrected chance count
    cand = dataclasses.replace(
        st, lam=lam_t, mu=st.mu + _GAMMA / st.lam - _GAMMA / lam_t)
    e0 = float(cand.evalues(np.asarray([T1]), n_db, len_hist)[0])
    if not (e0 > 0.0) or not math.isfinite(e0):
        return st
    # cc1 already estimates whole-database chance exceedances (the raw
    # counts cover all n_db sequences and the F-division restores the
    # censored mass above s_k) — no n_db/n_fit rescale.  The shift is a
    # fixed-point iteration, not one log-linear solve: at p ~ 1e-2 the
    # exact Gumbel tail curves away from the pure exponential enough to
    # leave a few-percent anchoring error after a single step.
    delta = 0.0
    e_cur = e0
    for _ in range(8):
        delta += math.log(cc1 / e_cur) / lam_t
        shifted = dataclasses.replace(cand, a=cand.a + delta,
                                      mu=cand.mu + delta)
        e_cur = float(shifted.evalues(np.asarray([T1]), n_db,
                                      len_hist)[0])
        if not (e_cur > 0.0) or not math.isfinite(e_cur):
            return st
        if abs(math.log(cc1 / e_cur)) < 1e-9:
            break
    return dataclasses.replace(cand, a=cand.a + delta, mu=cand.mu + delta)
