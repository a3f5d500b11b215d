"""Readings behind the limits of ``chip_smoke.py`` phase E3 (the train
twin steps), on one CUDA card.

    python scripts/twin_limits.py [--seeds 7,8,9,10,11,12] [--json PATH]

Runs ``chip_smoke.py`` in full with phase E3 at every seed of ``--seeds``
per bucket. Besides E3's own lines (kernel and 1xTF32 stand-in twins with
ReLU ties pinned to the plain twin's side), each kernel and stand-in twin
is stepped once more unpinned and compared with the same plain twin; those
readings are printed as ``unpinned`` lines. ``--json`` is passed on to
``chip_smoke.py``. Exits with ``chip_smoke.py``'s code.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="7,8,9,10,11,12", help="E3's draws per bucket")
    parser.add_argument("--json", default=None, help="chip_smoke.py's full report")
    args = parser.parse_args(argv)

    import chip_smoke as cs

    cs.TWIN_SEEDS = tuple(int(s) for s in args.seeds.split(","))
    pinned_step, last = cs.twin_step, {}

    def twin_step(model, route, tc, log_dir, batch, seed, so3, torus, dev, pin=None):
        out = pinned_step(model, route, tc, log_dir, batch, seed, so3, torus, dev, pin=pin)
        if route == "plain":
            last["plain"] = out
        elif pin is not None:
            free = pinned_step(model, route, tc, log_dir, batch, seed, so3, torus, dev)
            c = cs.compare_twins(model, last["plain"], free, tc.lr)
            sw = c["relu_switched"]
            cs._log(f"  unpinned {route} twin, {batch.rec_cat.shape[1]} receptor rows, seed {seed}: metric "
                    f"{c['metric_rel_err']:.3e} | all leaves {c['grad_all_rel_err']:.3e} | worst leaf "
                    f"{c['grad_norm_rel_err']:.3e} | worst element {c['grad_elem_rel_err']:.3e} | solid weights "
                    f"{c['param_solid_err_lr']:.3e} lr | any weight {c['param_err_lr']:.3e} lr | batch stats "
                    f"{c['batch_stat_rel_err']:.3e} | switched {sw['total']}, the largest "
                    f"{sw['largest_share']:.2e} | outside {', '.join(c['outside']) or 'none'}")
        return out

    cs.twin_step = twin_step
    return cs.main([] if args.json is None else ["--json", args.json])


if __name__ == "__main__":
    sys.exit(main())
