"""
The "closed_jobs" protocol: DMET jobs back to back, each waiting for the
last, in rounds.  A round runs one job from each start, in an order drawn
from the run's seed; the window ends with the round in flight.  Its mix
(traffic/<mix>.json) is data alone:

    protocol  "closed_jobs"
    filling   electrons per spin-orbital of the lattice
    max_iter  DMET iterations per job
    start     {"vcor": "diagonal", "alpha": [...], "beta": [...],
              "noise": s, "draws": [d, ...]}: one start per draw d, per
              spin a diagonal cell potential (an antiferromagnetic guess)
              plus s * N(0, 1) on every vcor parameter from the stream d

Every run meets the same starts, so every seed gives the window the same
work; the seed orders the rounds and draws the job the reference judges.

A protocol module gives: check(mix), prepare(prog, mix, seed) -> state,
warm(prog, mix, state), run(prog, mix, state, seconds) -> answers,
work(answers) -> {name: count}, judged(answers, seed) -> (answer,
iterations to judge).
"""

import time

import numpy as np

# iterations of the judged job whose impurity problem the reference solves
# again (the last and others drawn from the seed): the whole job takes the
# reference about as long as the window
JUDGED_ITERATIONS = 3


def check(mix):
    if mix["start"]["vcor"] != "diagonal":
        raise ValueError("unknown start %s" % mix["start"]["vcor"])


def _rng(seed, stream):
    # any whole number, negative or beyond 64 bits, maps to one stream
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def start_vcor(mix, nparam, draw):
    """One start: unrestricted local vcor parameters (nparam,), per spin
    the upper triangle of the cell matrix row by row, the noise from the
    stream `draw`."""
    st = mix["start"]
    n = len(st["alpha"])
    assert nparam == n * (n + 1)
    iu = np.triu_indices(n)
    p = np.concatenate([np.diag(st[s])[iu] for s in ("alpha", "beta")])
    return p + st["noise"] * _rng(draw, 0).standard_normal(nparam)


def starts(mix, nparam):
    """The starts of a round, one per draw of the mix."""
    return [start_vcor(mix, nparam, d) for d in mix["start"]["draws"]]


def round_order(n_starts, seed):
    """The order of the starts in the run's rounds."""
    return _rng(seed, 3).permutation(n_starts).tolist()


def judged_job(n_jobs, seed):
    """Index of the job of the window that the reference judges."""
    return int(_rng(seed, 1).integers(n_jobs))


def judged_iterations(n_iter, seed, k):
    """The iterations of the judged job whose impurity problem the
    reference solves again: the last and k - 1 others drawn from the
    seed."""
    rest = _rng(seed, 2).permutation(n_iter - 1)[:k - 1]
    return sorted(set(rest.tolist()) | {n_iter - 1})


def job(prog, mix, start, max_iter):
    """One job from `start`, the start kept with the answer."""
    return dict(prog.job(start, mix["filling"], max_iter), start=start)


def prepare(prog, mix, seed):
    s = starts(mix, prog.nparam)
    return {"starts": s, "order": round_order(len(s), seed)}


def warm(prog, mix, state):
    """One DMET iteration: every shape and kernel of the cell's jobs."""
    job(prog, mix, state["starts"][state["order"][0]], 1)


def run(prog, mix, state, seconds):
    """Whole rounds until `seconds` have passed: the window's answers."""
    answers = []
    t0 = time.perf_counter()
    while not answers or time.perf_counter() - t0 < seconds:
        for i in state["order"]:
            answers.append(job(prog, mix, state["starts"][i],
                               mix["max_iter"]))
    return answers


def work(answers):
    return {"jobs": len(answers),
            "iterations": sum(len(a["history"]) for a in answers)}


def judged(answers, seed):
    a = answers[judged_job(len(answers), seed)]
    return a, judged_iterations(len(a["history"]), seed, JUDGED_ITERATIONS)
