"""chip_smoke.py's CPU-checkable parts: its decks route where they
claim to, and the script refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flagship_deck_routes_to_sedov_dgp1():
    from quinoa_tpu.control.config import build_inciter, load_inciter
    from quinoa_tpu.inciter.dg import DGSolver
    from quinoa_tpu.mesh import box_tet_mesh

    cfg = load_inciter(chip_smoke.flagship_deck())
    assert (cfg.scheme, cfg.pde, cfg.problem) == ("dgp1", "compflow",
                                                  "sedov_blastwave")
    assert (cfg.flux, cfg.limiter) == ("hllc", "superbeep1")
    assert cfg.nstep == chip_smoke.FLAGSHIP_STEPS
    assert sorted(cfg.bc_sym) == [1, 2, 3, 4, 5, 6]
    solver, _ = build_inciter(cfg, box_tet_mesh(2, 2, 2))
    assert isinstance(solver, DGSolver)
    assert solver.geom.ndof == 4 and solver.limiter == "superbeep1"
    assert solver.system.riemann_flux == "hllc"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_a_cpu_only_process(where, tmp_path):
    """No accelerator (or no repo beside the script): a non-zero exit
    and no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("zmom, ref_zmom, ok", [
    # a resolved small component (Sedov's z-momentum, 3e-4 of the
    # energy) is held to its own size: 1e-3 off fails at rtol 5e-4
    (0.026026, 0.026, False),
    (0.0260001, 0.026, True),
    # a component f32 cannot resolve (below ROUNDOFF of the largest) is
    # measured against the largest
    (2.5e-6, 2.4e-6, True),
])
def test_compare_l2_scales_each_component(zmom, ref_zmom, ok):
    head = ["it", "t", "L2(u0)", "L2(u1)", "L2(err:u0)"]
    ref = [[10, 0.1, 92.5, ref_zmom, 1.0]]
    got = [[10, 0.1, 92.5, zmom, 7.0]]
    worst, passed = chip_smoke.compare_l2(head, got, ref, 5e-4)
    assert passed is ok
    if ref_zmom < chip_smoke.ROUNDOFF * 92.5:
        assert worst == abs(zmom - ref_zmom) / 92.5
    else:
        assert worst == abs(zmom - ref_zmom) / ref_zmom
