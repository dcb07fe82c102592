"""The comparison that decides `correct`.

Every answer that the window produced is checked for what can be checked
cheaply, and a sample drawn from the seed is checked in full against the
reference's search of the whole database:

- unanswered: queries or requests with no answer (an error, or none
  within the wait after the window), limit 0;
- echo_mismatch: answers whose query title or length is not the one sent
  (a coalesced dispatch sliced back to the wrong request), limit 0;
- hit_order_mismatch: answers whose hits are not k, by score descending
  and, among equal scores, by id ascending, limit 0;
- hit_title_mismatch: hits whose title is not the reference's title of
  that id, limit 0;
- hit_score_mismatch: hits whose score is not the reference's score of
  that query against that subject, limit 0;
- alignment_mismatch (a configuration that aligns, and only there): hits
  whose alignment is missing or not an optimal alignment of that query and
  subject with the hit's score and its counts (`alignment.Judge`), limit 0;
- topk_mismatch (sample): ranks whose (score, id) differ from the
  reference's top-k over the whole database, limit 0;
- evalue_log_gap (sample): the widest |ln E - ln E_ref| over the sample's
  hits, limit from the mix (set from readings: see PERF.md).
"""

import dataclasses
import math
import time

import numpy as np


@dataclasses.dataclass
class Answer:
    """One query's answer as the program gave it."""
    query: np.ndarray            # int8 codes sent
    title_sent: str
    answered: bool = False
    title: str = ""
    length: int = -1
    scores: np.ndarray = None    # int[k]
    ids: np.ndarray = None       # int[k]
    titles: list = None
    evalues: np.ndarray = None   # float[k] or None
    alignments: list = None      # [dict of the ten fields, or None]


def _ln(e):
    return math.log(max(float(e), 1e-300))


def evalue_gap(ev, refs) -> float:
    """The widest |ln E - ln E_ref| over the hits, against the nearest of
    the reference's admissible E-value vectors `refs`; inf when only one
    side has E-values or their counts differ."""
    def gap(ref):
        if ev is None and ref is None:
            return 0.0
        if ev is None or ref is None or len(ev) != len(ref):
            return math.inf
        return max((abs(_ln(a) - _ln(b)) for a, b in zip(ev, ref)),
                   default=0.0)
    return min(gap(r) for r in refs)


def draw_sample(answers, seed: int, spec: dict):
    """Indices of the answered queries to check in full: a seeded
    permutation, first one longer than `one_over` residues (where the mix
    names it), then any that still fit `residues` in all, at least
    `min_queries` (the shortest ones, if none fit)."""
    rng = np.random.default_rng([int(seed), 6])
    ok = [i for i, a in enumerate(answers) if a.answered]
    order = [ok[j] for j in rng.permutation(len(ok))]
    budget = int(spec.get("residues", 0))
    over = spec.get("one_over")
    pick, used = [], 0
    if over is not None:
        for i in order:
            n = answers[i].query.size
            if int(over) < n <= budget:
                pick.append(i)
                used += n
                break
    for i in order:
        n = answers[i].query.size
        if i not in pick and used + n <= budget:
            pick.append(i)
            used += n
    need = int(spec.get("min_queries", 1)) - len(pick)
    if need > 0:
        rest = sorted((i for i in ok if i not in pick),
                      key=lambda i: answers[i].query.size)
        pick += rest[:need]
    return pick


def _pair_groups(pairs):
    """Pairs grouped by the power of two above their query's length, so
    that a sweep runs no more rows than its longest query needs."""
    groups = {}
    for p in pairs:
        groups.setdefault(max(p[0].size, 1).bit_length(), []).append(p)
    return groups.values()


def check(ref, answers, sample, limits: dict, log=None, judge=None):
    """{name: (value, limit)} of every number compared; with a judge
    (alignment.Judge), `alignment_mismatch` too."""
    t0 = time.perf_counter()
    k = ref.k
    n_ids = len(ref.titles)
    out = {}
    ans = [a for a in answers if a.answered]
    out["unanswered"] = (len(answers) - len(ans), 0)
    out["echo_mismatch"] = (sum(a.title != a.title_sent or
                                a.length != a.query.size for a in ans), 0)
    order = 0
    for a in ans:
        s, i = np.asarray(a.scores), np.asarray(a.ids)
        if s.size != k or i.size != k or np.any(np.diff(s) > 0) or \
                np.any((np.diff(s) == 0) & (np.diff(i) <= 0)):
            order += 1
    out["hit_order_mismatch"] = (order, 0)
    titles = 0
    pairs = []
    for a in ans:
        for s, i, t in zip(a.scores, a.ids, a.titles):
            i = int(i)
            if not 0 <= i < n_ids:
                titles += 1
                continue
            titles += t != ref.titles[i]
            pairs.append((a.query, i, int(s)))
    out["hit_title_mismatch"] = (titles, 0)
    bad = 0
    for grp in _pair_groups(pairs):
        got = ref.pair_scores([p[0] for p in grp], [p[1] for p in grp])
        bad += int(np.sum(got != np.asarray([p[2] for p in grp])))
    out["hit_score_mismatch"] = (bad, 0)
    if log:
        log(f"check: {len(pairs)} hits rescored in "
            f"{time.perf_counter() - t0:.2f} s")
    if judge is not None:
        t1 = time.perf_counter()
        out["alignment_mismatch"] = (judge.mismatches(ans), 0)
        if log:
            log(f"check: {sum(len(a.ids) for a in ans)} alignments in "
                f"{time.perf_counter() - t1:.2f} s")
    topk, gap = 0, 0.0
    for idx in sample:
        a = answers[idx]
        r = ref.search(a.query)
        s, i = np.asarray(a.scores), np.asarray(a.ids)
        topk += ref.k if s.shape != r.scores.shape or \
            i.shape != r.ids.shape else \
            int(np.sum((s != r.scores) | (i != r.ids)))
        gap = max(gap, evalue_gap(a.evalues, r.evalues))
    out["topk_mismatch"] = (topk, 0)
    out["evalue_log_gap"] = (gap, float(limits["evalue_log_gap"]))
    return out


def control_answers(ref, queries):
    """The answers of the control: the reference one precision step down
    (16-bit saturating scores, moments rounded to bfloat16) in the
    program's place, to be judged by `check` as the program's are."""
    out = []
    for n, q in enumerate(queries):
        c = ref.search(q, control=True)
        out.append(Answer(q, f"q{n}", answered=True, title=f"q{n}",
                          length=q.size, scores=c.scores, ids=c.ids,
                          titles=[ref.titles[int(i)] for i in c.ids],
                          evalues=c.evalues[0]))
    return out


def passed(checks) -> bool:
    return all(v <= lim for v, lim in checks.values())
