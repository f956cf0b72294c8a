"""Smoke test of quinoa_tpu on NVIDIA GPUs, through the user entry points.

    python chip_smoke.py             # phases (a), (b), (c) on one card
    python chip_smoke.py --cards 4   # phases (a) and (d) on four cards

(a) Device: JAX must run on a GPU (it never falls back to the CPU); the
    devices and the card's name and power limit are printed.
(b) Flagship: Sedov blast, DG(P1) + HLLC + Superbee, symmetry walls, on
    the 48^3 box (663,552 tets) through `quinoa_tpu inciter` for 11
    steps.  Prints the diagnostics rows, the first step's time (compile
    included) and the median step time; checks the L2 gate of bench.py
    (tools/bench_l2_known_good.json, from an f64 CPU run, rtol 5e-4).
(c) Parity: each scheme the CLI routes to runs here in f32 and in a
    CPU-only child process in f64 (the plain reference); the final
    diagnostics must agree within each case's stated tolerance.  Where
    f64 solves a differently regularised system (F32_REFERENCE), the
    card is also held to a CPU-only f32 run of the same deck.
(d) Four cards: `inciter --npes 4` against `--npes 1` for the flagship
    and for DiagCG SlotCyl, and `walker --npes 4` against one card.

Any failed phase exits non-zero.  Only when all pass does the last line
print {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
L2_KNOWN_GOOD = os.path.join(ROOT, "tools", "bench_l2_known_good.json")
#: bench.py's matched-L2 gate (a limiter branch can flip on a 1-ulp
#: difference, so limited runs are held to this, not to f32 round-off)
L2_RTOL = 5e-4
#: smooth problems: f32 round-off accumulated over a few steps
SMOOTH_RTOL = 1e-5
#: an L2 component this far below the largest (about ten f32 ulps) is
#: below what an f32 run resolves, e.g. a 2-D flow's z-momentum
ROUNDOFF = 1e-6

FLAGSHIP_N = 48
FLAGSHIP_STEPS = 11


# -- decks --------------------------------------------------------------------


def _inciter_deck(nstep, scheme, body, extra=""):
    return f"""
inciter
  nstep {nstep}
  cfl 0.5
  scheme {scheme}
{extra}{body}
  diagnostics interval 1 error l2 end
end
"""


SEDOV = """  compflow
    physics euler problem sedov_blastwave
    material gamma 1.4 end end
    bc_sym sideset 1 2 3 4 5 6 end end
  end
"""


def flagship_deck(nstep=FLAGSHIP_STEPS):
    """The bench configuration as a deck: Sedov DG(P1) + HLLC +
    Superbee with symmetry walls (bench.py main)."""
    return _inciter_deck(nstep, "dgp1", SEDOV,
                         "  flux hllc\n  limiter superbeep1\n")


def slotcyl_deck(scheme, nstep):
    return _inciter_deck(nstep, scheme, """  transport
    physics advection problem slot_cyl ncomp 1 depvar c
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
""")


def walker_deck(npar, nstep):
    """Two-component diagonal Ornstein-Uhlenbeck ensemble."""
    return f"""
walker
  nstep {nstep}  term {nstep * 0.01:g}  dt 0.01  npar {npar}
  rngs r123_threefry end end
  diag_ou
    depvar o  ncomp 2  init zero  coeff const
    sigmasq 0.25 1.0 end  theta 1.0 1.0 end  mu 0.0 1.5 end
    rng r123_threefry
  end
  statistics interval {nstep} <O1> <O2> <o1o1> <o2o2> end
end
"""


#: phase (c) cases: name -> (deck, box (n, lo, hi), rtol, reason)
def parity_cases(n=16):
    unit = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    centred = ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    return {
        "dgp2_taylorgreen": (
            _inciter_deck(5, "dgp2", """  compflow
    physics euler problem taylor_green
    material gamma 1.66666666666667 end end
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
""", "  flux hllc\n"), (n,) + unit, SMOOTH_RTOL,
            "smooth and unlimited: only f32 round-off separates the runs"),
        "pdg_sedov": (
            _inciter_deck(10, "pdg", SEDOV,
                          "  flux hllc\n  limiter superbeep1\n"),
            (n,) + unit, L2_RTOL,
            "limited and p-adaptive: a 1-ulp difference can flip a "
            "Superbee branch or an element's order"),
        "multimat_p1_interface": (
            _inciter_deck(10, "dgp1", """  multimat
    physics veleq problem interface_advection nmat 3
    material gamma 1.4 1.4 1.4 end cv 83.33 717.5 717.5 end end
    bc_extrapolate sideset 1 2 3 4 5 6 end end
  end
"""), (n,) + unit, 2e-2,
            "physics check only: f32 floors trace volume fractions at "
            "50 eps = 6e-6 where the problem seeds them at 1e-12, so f32 "
            "and f64 solve differently regularised systems (8.5e-3 apart "
            "on the CPU at 16^3); F32_REFERENCE holds the card tighter"),
        "diagcg_fct_slotcyl": (
            slotcyl_deck("diagcg", 10), (n,) + unit, L2_RTOL,
            "FCT limiting selects by min/max of f32 sums"),
        "alecg_slotcyl": (
            slotcyl_deck("alecg", 10), (n,) + unit, SMOOTH_RTOL,
            "linear scheme (edge Rusanov on a static velocity field): "
            "only f32 round-off separates the runs"),
        "alecg_vortical": (
            _inciter_deck(10, "alecg", """  compflow
    physics euler problem vortical_flow
    alpha 0.1 beta 1.0 p0 10.0
    material gamma 1.66666666666667 end end
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
"""), (n,) + centred, SMOOTH_RTOL,
            "smooth manufactured solution, no limiter"),
        "walker_ou": (
            walker_deck(1_000_000, 20), None, 6.0,
            "f32 and f64 draw different random streams: the moments "
            "must agree within 6 standard errors of the difference"),
    }


#: cases also run in f32 by the CPU child: name -> (rtol, reason).  The
#: card's f32 run must match the CPU's f32 run of the same deck where the
#: f64 run solves a differently regularised system.
F32_REFERENCE = {
    "multimat_p1_interface": (
        L2_RTOL,
        "same f32 regularisation on both sides; the volume-fraction "
        "floor and bounds clip by min/max, which a 1-ulp difference can "
        "flip"),
}


# -- running the CLI ------------------------------------------------------------


def write_box(path, n, lo, hi):
    from quinoa_tpu.io import write_exodus
    from quinoa_tpu.mesh import box_tet_mesh

    write_exodus(path, box_tet_mesh(n, n, n, lo=lo, hi=hi))


def run_cli(argv):
    """quinoa_tpu's CLI in-process; returns its stdout (raises on a
    non-zero exit)."""
    from quinoa_tpu.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"quinoa_tpu {' '.join(argv)} exited {rc}")
    return out.getvalue()


def run_case(work, name, deck, box, tag, npes=1):
    """Write deck (and mesh) under work/, run it, return the output
    table's path (diagnostics, or walker statistics)."""
    base = os.path.join(work, name)
    if not os.path.exists(base + ".q"):
        with open(base + ".q", "w") as f:
            f.write(deck)
    out = f"{base}.{tag}.txt"
    if box is None:
        run_cli(["walker", "-c", base + ".q", "--stat", out, "--seed", "7"]
                + (["--npes", str(npes)] if npes > 1 else []))
        return out, None
    if not os.path.exists(base + ".exo"):
        write_box(base + ".exo", *box)
    prof = run_cli(["inciter", "-c", base + ".q", "-i", base + ".exo",
                    "--diag", out, "-b", "--profile", "--npes", str(npes)])
    return out, prof


def read_table(path):
    """Rows of a diagnostics/statistics file as float lists + header."""
    with open(path) as f:
        lines = f.read().splitlines()
    head = [c.split(":", 1)[1] for c in lines[0].lstrip("# ").split("\t")]
    rows = [[float(x) for x in ln.split()] for ln in lines[1:] if ln.strip()]
    return head, rows


def step_times_ms(profile_table):
    """(first, median) ms of the "timestep" phase of a --profile table."""
    for ln in profile_table.splitlines():
        tok = ln.split()
        if tok and tok[0] == "timestep":
            return float(tok[-2]), float(tok[-1])
    raise RuntimeError("no timestep row in the profile table")


def compare_l2(head, got, ref, rtol):
    """Worst relative difference of t and every L2(sol) column of the
    final rows, each measured against its own reference size.  Only a
    component below ROUNDOFF of the largest, which f32 cannot resolve, is
    measured against the largest instead."""
    idx = [i for i, h in enumerate(head)
           if h.startswith("L2(") and "err" not in h]
    g, r = got[-1], ref[-1]
    big = max(abs(r[i]) for i in idx)
    it = head.index("t")
    worst = abs(g[it] - r[it]) / abs(r[it])
    for i in idx:
        scale = abs(r[i]) if abs(r[i]) > ROUNDOFF * big else big
        worst = max(worst, abs(g[i] - r[i]) / scale)
    return worst, worst <= rtol


def compare_moments(head, got, ref, nsig, npar):
    """Final-row walker moments, in standard errors of the difference of
    two independent ensembles of npar particles (Gaussian estimates:
    se(mean) = sqrt(var/N), se(var) = var*sqrt(2/N)); returns the worst
    z-score."""
    g, r = got[-1], ref[-1]
    var = {h[1:-1]: r[i] for i, h in enumerate(head)
           if h.startswith("<") and h[1:-1].islower()}
    worst = 0.0
    for i, h in enumerate(head):
        if not h.startswith("<"):
            continue
        key = h[1:-1]
        if key.isupper():       # a mean <O1>: its variance is <o1o1>
            se = (2.0 * var[key.lower() * 2] / npar) ** 0.5
        else:                   # a central moment <o1o1>
            se = 2.0 * abs(r[i]) / npar ** 0.5
        worst = max(worst, abs(g[i] - r[i]) / se)
    return worst, worst <= nsig


# -- phases -------------------------------------------------------------------------


def phase_device(cards):
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is "
                         f"{jax.default_backend()!r}, not 'gpu'")
    devs = jax.devices()
    print("devices:", devs, flush=True)
    if len(devs) < cards:
        raise SystemExit(f"chip_smoke: {cards} cards needed, "
                         f"{len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print("nvidia-smi:", smi.stdout.strip().replace("\n", " | "),
          flush=True)
    d = devs[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def phase_flagship(work, n=FLAGSHIP_N):
    box = (n, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    diag, prof = run_case(work, "flagship", flagship_deck(), box, "gpu")
    head, rows = read_table(diag)
    for r in rows:
        print("  diag:", " ".join(f"{x:.6e}" for x in r), flush=True)
    first, med = step_times_ms(prof)
    print(f"flagship ({6 * n ** 3} tets): first step {first / 1e3:.2f} s "
          f"(compile included), median {med:.3f} ms/step", flush=True)
    l2 = [rows[-1][head.index(h)] for h in head
          if h.startswith("L2(") and "err" not in h]
    import math

    if not all(math.isfinite(x) for x in rows[-1]):
        raise SystemExit("chip_smoke: non-finite flagship diagnostics")
    with open(L2_KNOWN_GOOD) as f:
        good = json.load(f)["l2sol"]
    dev = max(abs(a - b) / abs(b) for a, b in zip(l2, good))
    print(f"flagship L2 gate: max rel deviation {dev:.3e} "
          f"(rtol {L2_RTOL}) per component "
          + " ".join(f"{abs(a - b) / abs(b):.3e}" for a, b in zip(l2, good)),
          flush=True)
    if len(rows) != FLAGSHIP_STEPS or dev > L2_RTOL:
        raise SystemExit("chip_smoke: flagship L2 gate failed")


def phase_parity(work, n=16):
    cases = parity_cases(n)
    names = list(cases)
    for name in names:   # inputs first: the child reads the same files
        deck, box, _, _ = cases[name]
        with open(os.path.join(work, name + ".q"), "w") as f:
            f.write(deck)
        if box is not None:
            write_box(os.path.join(work, name + ".exo"), *box)
    # the children stay off the card and off the shared compile cache:
    # CPU code cached on another host may use instructions this one lacks
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", QUINOA_TEST_CACHE="0")
    runs = [("cpu64", names),
            ("cpu32", [m for m in names if m in F32_REFERENCE])]
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference",
         work, str(n), tag] + todo, env=env) for tag, todo in runs if todo]
    try:
        for name in names:
            deck, box, _, _ = cases[name]
            run_case(work, name, deck, box, "gpu")
        rcs = [c.wait(timeout=900) for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    if any(rcs):
        raise SystemExit(f"chip_smoke: CPU reference children exited {rcs}")
    failed = []
    for name in names:
        _, box, tol, why = cases[name]
        base = os.path.join(work, name)
        head, got = read_table(base + ".gpu.txt")
        checks = [("f64", ".cpu64.txt", tol, why)]
        if name in F32_REFERENCE:
            checks.append(("f32", ".cpu32.txt") + F32_REFERENCE[name])
        for prec, suffix, tol, why in checks:
            _, ref = read_table(base + suffix)
            if box is None:
                worst, ok = compare_moments(head, got, ref, tol, 1_000_000)
                unit = "standard errors"
            else:
                worst, ok = compare_l2(head, got, ref, tol)
                unit = "relative"
            print(f"parity {name} vs CPU {prec}: worst {worst:.3e} {unit} "
                  f"(tolerance {tol}: {why}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failed.append(f"{name} vs CPU {prec}")
    if failed:
        raise SystemExit(f"chip_smoke: parity failed for {failed}")


def phase_cards(work, n=FLAGSHIP_N, npar=4_000_000):
    """inciter/walker over four cards against one."""
    box = (n, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    cases = [("flagship", flagship_deck(), box, L2_RTOL),
             ("diagcg_fct_slotcyl", slotcyl_deck("diagcg", 10), box,
              L2_RTOL)]
    failed = []
    for name, deck, b, tol in cases:
        times = {}
        for npes in (1, 4):
            path, prof = run_case(work, name, deck, b, f"npes{npes}", npes)
            times[npes] = step_times_ms(prof)
        head, one = read_table(os.path.join(work, f"{name}.npes1.txt"))
        _, four = read_table(os.path.join(work, f"{name}.npes4.txt"))
        worst, ok = compare_l2(head, four, one, tol)
        print(f"cards {name}: npes 4 vs 1 worst {worst:.3e} relative "
              f"(tolerance {tol}) {'ok' if ok else 'FAIL'}; median "
              f"ms/step npes1 {times[1][1]:.3f}, npes4 {times[4][1]:.3f}",
              flush=True)
        if not ok:
            failed.append(name)
    deck = walker_deck(npar, 20)
    for npes in (1, 4):
        run_case(work, "walker", deck, None, f"npes{npes}", npes)
    head, one = read_table(os.path.join(work, "walker.npes1.txt"))
    _, four = read_table(os.path.join(work, "walker.npes4.txt"))
    # identical random streams: only the reduction order differs
    worst, ok = compare_moments(head, four, one, 1e-2, npar)
    print(f"cards walker: 4 cards vs 1 worst {worst:.3e} standard errors "
          f"(tolerance 1e-2: same draws, f32 reduction order) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failed.append("walker")
    if failed:
        raise SystemExit(f"chip_smoke: four-card parity failed for {failed}")


def cpu_reference(work, n, tag, names):
    """The CPU runs of phase (c) (child process, JAX_PLATFORMS=cpu):
    tag "cpu64" in f64, "cpu32" in f32."""
    import jax

    jax.config.update("jax_enable_x64", tag == "cpu64")
    cases = parity_cases(n)
    for name in names:
        deck, box, _, _ = cases[name]
        run_case(work, name, deck, box, tag)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card phase (d)")
    ap.add_argument("--cpu-reference", nargs="+", metavar="ARG",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        work, n, tag, *names = args.cpu_reference
        cpu_reference(work, int(n), tag, names)
        return 0

    from quinoa_tpu.base.xlacache import enable_compile_cache

    enable_compile_cache()
    device = phase_device(args.cards)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-",
                                     dir=ROOT) as work:
        if args.cards == 4:
            phase_cards(work)
        else:
            phase_flagship(work)
            phase_parity(work)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
