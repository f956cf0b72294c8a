"""Multi-host (hierarchical) sharding: 2-level partition + host-major
device order so halo ppermute pairs stay inside a host (NVLink), only
region boundaries cross the network between hosts (SURVEY §5.8; the
recipe of keeping the chatty axis on the fast interconnect)."""

import numpy as np
import pytest

from quinoa_tpu.cli import main
from quinoa_tpu.io import write_mesh
from quinoa_tpu.mesh import box_tet_mesh
from quinoa_tpu.parallel.partition import (partition_elements,
                                           partition_hierarchical)


def _cross_slice_faces(mesh, part, cps):
    """Count element-adjacency pairs whose shards live on different
    slices (slice = shard // cps)."""
    from quinoa_tpu.mesh.derived import gen_esuel

    esuel = gen_esuel(mesh.inpoel, mesh.nnode)
    e = np.arange(mesh.nelem)[:, None].repeat(4, 1)
    nbr = esuel
    m = (nbr >= 0) & (part[np.maximum(nbr, 0)] != part[e])
    cross_shard = m.sum()
    sl = part // cps
    ms = (nbr >= 0) & (sl[np.maximum(nbr, 0)] != sl[e])
    return ms.sum(), cross_shard


def test_hierarchical_partition_balance_and_locality():
    mesh = box_tet_mesh(12, 12, 12)
    cps = 4
    ph = partition_hierarchical(mesh.coords, mesh.inpoel, 2, cps)
    counts = np.bincount(ph, minlength=8)
    assert counts.min() >= 0.8 * counts.max()
    # the hierarchical cut crosses slices strictly less than it crosses
    # shards (most halo pairs are intra-slice)
    cross_slice, cross_shard = _cross_slice_faces(mesh, ph, cps)
    assert cross_slice < 0.55 * cross_shard
    # and no more cross-slice traffic than a flat partition read
    # slice-major would produce
    pf = partition_elements(mesh.coords, mesh.inpoel, 8)
    cross_slice_flat, _ = _cross_slice_faces(mesh, pf, cps)
    assert cross_slice <= cross_slice_flat


def _read_diag(path):
    rows = [ln.split() for ln in open(path) if not ln.startswith("#")]
    return np.array([[float(x) for x in r] for r in rows])


@pytest.mark.parametrize("scheme", [
    "diagcg",
    pytest.param("dg", marks=pytest.mark.slow),
    pytest.param("alecg", marks=pytest.mark.slow),
])
def test_cli_slices_matches_single(tmp_path, scheme):
    """--npes 8 --slices 2 reproduces the single-device diag file."""
    DECKS = ("/root/reference/tests/regression/inciter/transport/"
             "SlotCyl/asynclogic")
    meshfile = str(tmp_path / "box.exo")
    write_mesh(meshfile, box_tet_mesh(8, 8, 4, hi=(1.0, 1.0, 0.5)))
    deck = f"{DECKS}/slot_cyl_{scheme}.q"
    d1, d8 = str(tmp_path / "d1"), str(tmp_path / "d8")
    assert main(["inciter", "-c", deck, "-i", meshfile, "--diag", d1,
                 "-o", str(tmp_path / "o1")]) == 0
    assert main(["inciter", "-c", deck, "-i", meshfile, "--diag", d8,
                 "-o", str(tmp_path / "o8"), "--npes", "8",
                 "--slices", "2"]) == 0
    np.testing.assert_allclose(_read_diag(d8), _read_diag(d1),
                               rtol=1e-9, atol=1e-12)
