"""Regenerate tools/bench_l2_known_good.json from an f64 CPU run.

    JAX_PLATFORMS=cpu python tools/regen_l2_known_good.py [n]

Runs the bench configuration (chip_smoke.flagship_deck: Sedov DG(P1) +
HLLC + Superbee, symmetry walls, 11 steps) on the n^3 box (default 48,
the bench's size) through `quinoa_tpu inciter` in float64 on the CPU,
and writes the final L2(sol) row as the known-good that bench.py and
chip_smoke.py gate the accelerator's f32 run against (other sizes only
print it).  At 48^3 it needs
a few GiB of memory and a few minutes of a multi-core CPU.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax

    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    jax.config.update("jax_enable_x64", True)
    import chip_smoke

    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.FLAGSHIP_N
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-",
                                     dir=ROOT) as work:
        diag, _ = chip_smoke.run_case(
            work, "flagship", chip_smoke.flagship_deck(),
            (n, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), "cpu64")
        head, rows = chip_smoke.read_table(diag)
    l2 = [rows[-1][i] for i, h in enumerate(head)
          if h.startswith("L2(") and "err" not in h]
    out = {
        "config": (f"Sedov {n}^3 DG(P1) HLLC Superbee, "
                   f"{chip_smoke.FLAGSHIP_STEPS} steps, through the CLI"),
        "harvested": "float64 on the CPU (tools/regen_l2_known_good.py)",
        "l2sol": l2,
    }
    print(json.dumps(out))
    if n == chip_smoke.FLAGSHIP_N:    # other sizes only print
        with open(os.path.join(ROOT, "tools", "bench_l2_known_good.json"),
                  "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")


if __name__ == "__main__":
    main()
