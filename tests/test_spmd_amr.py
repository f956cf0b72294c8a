"""Sharded during-timestep AMR: the --npes resharding event reproduces
the single-device dtref runs (and hence the reference's committed dtref
baselines, which test_reference_parity checks for the single-device
path).

The reference refines distributed with cross-chare compatibility
iteration and migrates (Refiner.cpp:417-431, Transporter.cpp:450-523);
the design here is 'static SPMD + reshard after AMR' (SURVEY §2.15):
gather -> retag/refine/transfer on host -> repartition -> rebuild the
sharded solver -> resume stepping.
"""

import numpy as np
import pytest

from quinoa_tpu.cli import main

pytestmark = pytest.mark.slow  # full-CLI runs

REF = "/root/reference/tests/regression"


def _load_diag(path):
    rows = [ln.split() for ln in open(path) if not ln.startswith("#")]
    return np.array([[float(x) for x in r] for r in rows])


@pytest.mark.parametrize("case", [
    ("gauss_hump.q", "unitcube_01_112_ss3.exo"),
    ("nleg_diagcg_amr.q", "unitcube_1k.exo"),
])
def test_spmd_dtref_matches_single(tmp_path, monkeypatch, case):
    deck, meshf = case
    base = f"{REF}/inciter/mesh_refinement/dtref/"
    monkeypatch.chdir(tmp_path)
    rc = main(["inciter", "-c", base + deck, "-i", base + meshf,
               "--diag", "d1"])
    assert rc == 0
    rc = main(["inciter", "-c", base + deck, "-i", base + meshf,
               "--diag", "d8", "--npes", "8"])
    assert rc == 0
    a, b = _load_diag("d1"), _load_diag("d8")
    assert a.shape == b.shape
    # the remesh/transfer happens on host identically; only the solver's
    # reduction order differs across shards
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12)
