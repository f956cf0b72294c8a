"""Secondary benchmark: walker SDE particle-updates/sec/chip.

Not consumed by the driver (bench.py is the single JSON line); run
manually to track the stochastic-particle path:

    python bench_walker.py [npar]

Configuration: the reference's coupled Langevin GLM deck
(tests/regression/walker/Velocity/glm_homogeneous_shear.q — position +
velocity + dissipation joint PDF, its heaviest walker composition) at
production ensemble size, moments estimated every chunk exactly as the
CLI runs it.
"""

import json
import sys
import time


def main():
    import jax

    from quinoa_tpu.base.xlacache import enable_compile_cache
    from quinoa_tpu.control.config import load_walker, build_walker
    from quinoa_tpu.statistics.stats import estimate_moments

    enable_compile_cache()
    npar = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    import re

    deck = open("/root/reference/tests/regression/walker/Velocity/"
                "glm_homogeneous_shear.q").read()
    deck = re.sub(r"npar\s+\d+", f"npar {npar}", deck)
    cfg = load_walker(deck)
    w = build_walker(cfg, seed=1)
    P = w.initialize()

    # warm one chunk, then time chained chunks
    chunk = 10
    P, _ = w.run(chunk, P=P)
    jax.block_until_ready(P)

    nchunk = 5
    t0 = time.perf_counter()
    for _ in range(nchunk):
        P, _ = w.run(chunk, P=P)
        mom = estimate_moments(P, w.offsets, cfg.ordinary, cfg.central)
    jax.block_until_ready(P)
    dt = time.perf_counter() - t0

    ups = npar * chunk * nchunk / dt
    print(json.dumps({
        "metric": "particle_updates_per_sec_langevin_coupled",
        "value": round(ups, 1),
        "unit": "particle-updates/s/chip",
        "npar": npar,
        "ms_per_step": dt / (chunk * nchunk) * 1e3,
        "device": jax.devices()[0].device_kind,
        "moments": {str(k): round(float(v), 6) for k, v in mom.items()},
    }))


if __name__ == "__main__":
    main()
