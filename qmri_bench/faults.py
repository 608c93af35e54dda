"""Faults the registration cell can have, planted in the program at run time,
and their readings at the cell's own size:

    python3 -m qmri_bench.faults --workload cubequant_t1rho.register_pair --seconds 12 \\
        --seeds 31 32 33 --faults adam_unchanged finest_level_skipped ...

For each fault and seed: a run of the cell with a short window (every
registration completed in it is kept), the program patched underneath,
judged as the benchmark judges it. ``shift_error_vox``'s limit lies between
the program's largest sound reading and the smallest reading of these
faults. The benchmark's own runs never plant a fault.

Each fault is a function of ``setattr(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or :func:`planted`'s), so the CPU tests plant the
same faults at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys


def adam_unchanged(setattr_):
    """The Adam step returns its state unchanged: the identity transform."""
    from dosma_tpu_torch.ops import registration

    setattr_(registration, "_adam_step", lambda theta, grad, mu, nu, it, lr: (theta, mu, nu))


def _levels(keep):
    def fault(setattr_):
        from dosma_tpu_torch.ops import registration

        real = registration._stage_sigmas
        setattr_(registration, "_stage_sigmas", lambda cfg: keep(real(cfg)))

    return fault


finest_level_skipped = _levels(lambda sigmas: sigmas[:-1])
finest_level_skipped.__doc__ = "The pyramid's last, unsmoothed level is skipped."
coarsest_level_skipped = _levels(lambda sigmas: sigmas[1:])
coarsest_level_skipped.__doc__ = "The pyramid's first, most smoothed level is skipped."


def _learning_rate(factor):
    def fault(setattr_):
        from dosma_tpu_torch.ops import registration

        real = registration._cosine_lrs
        setattr_(registration, "_cosine_lrs",
                 lambda lr, iterations: [factor * x for x in real(lr, iterations)])

    return fault


lr_tenth = _learning_rate(0.1)
lr_tenth.__doc__ = "The step size of every Adam iteration a tenth of the parameter file's."
lr_tenfold = _learning_rate(10.0)
lr_tenfold.__doc__ = "The step size of every Adam iteration ten times the parameter file's."

REGISTRATION = {"adam_unchanged": adam_unchanged,
                "finest_level_skipped": finest_level_skipped,
                "coarsest_level_skipped": coarsest_level_skipped,
                "lr_tenth": lr_tenth,
                "lr_tenfold": lr_tenfold}


@contextlib.contextmanager
def planted(fault):
    """``fault`` planted for the duration of the block."""
    saved = []

    def setattr_(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    fault(setattr_)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="cubequant_t1rho.register_pair")
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=sorted(REGISTRATION), choices=REGISTRATION)
    args = p.parse_args(argv)

    import torch

    from qmri_bench.run import run_cell

    if not torch.cuda.is_available():
        print("the faults are read on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    least = {}
    for name in args.faults:
        for seed in args.seeds:
            with planted(REGISTRATION[name]):
                r = run_cell(args.workload, seed, args.seconds, 0, device)
            numbers = {k: c["value"] for k, c in r["checks"].items()}
            print(json.dumps({"fault": name, "seed": seed, "correct": r["correct"],
                              "attempted": r["attempted"], "numbers": numbers}), flush=True)
            for k, v in numbers.items():
                least.setdefault(name, {})[k] = min(least.get(name, {}).get(k, math.inf), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds), "least": least}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
