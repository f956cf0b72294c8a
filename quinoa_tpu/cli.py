"""Command-line drivers: inciter, walker, meshconv.

Counterpart of the reference's five executables (src/Main/): the shared
`python -m quinoa_tpu <tool>` entry point dispatches to per-tool drivers
mirroring InciterDriver / WalkerDriver / MeshConvDriver.
"""

from __future__ import annotations

import argparse
import sys
import time


class _Preempt:
    """Graceful preemption drain: SIGTERM/SIGINT set a flag; the step
    loop finishes the current iteration, writes a restart checkpoint
    and the final outputs, and exits cleanly.  The analog of the
    reference's Charm++ checkpoint machinery under
    preemptible VMs (its `-r rsfreq` restart contract,
    src/Main/Inciter.cpp) — a preempted run resumes with `--restart`."""

    def __init__(self):
        self.flag = False
        self._old = {}

    def __enter__(self):
        import signal

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except ValueError:  # non-main thread: no handlers, no drain
                pass
        return self

    def _handler(self, signum, frame):
        import signal

        if self.flag:
            return  # already draining; original handlers restored below
        self.flag = True
        # restore the original handlers so a SECOND signal aborts a run
        # hung inside a step (e.g. a backend outage) instead of being
        # swallowed by the drain flag forever
        for sig, h in self._old.items():
            signal.signal(sig, h)

    def __exit__(self, *exc):
        import signal

        for sig, h in self._old.items():
            signal.signal(sig, h)
        return False


def _cmd_inciter(argv):
    ap = argparse.ArgumentParser(prog="quinoa_tpu inciter")
    ap.add_argument("-c", "--control", required=True, help=".q control file")
    ap.add_argument("-i", "--input", required=True, help="input mesh file")
    ap.add_argument("-o", "--output", default="out", help="field output basename")
    ap.add_argument("--diag", default="diag", help="diagnostics file")
    ap.add_argument("-r", "--rsfreq", type=int, default=0,
                    help="checkpoint every N steps (0 = off)")
    ap.add_argument("--restart", default=None,
                    help="restart from a checkpoint directory")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory (default: <output>.restart "
                         "next to the field output, so runs never litter "
                         "the invoking CWD)")
    ap.add_argument("--pieces", type=int, default=0,
                    help="write field output as N per-partition exodus "
                         "pieces (MeshWriter chare-group analog)")
    ap.add_argument("--sync-io", action="store_true",
                    help="write field output synchronously (default: a "
                         "worker thread overlaps file I/O with stepping, "
                         "the async MeshWriter analog)")
    ap.add_argument("-b", "--benchmark", action="store_true",
                    help="benchmark mode: no field output "
                         "(MeshWriter.cpp:101); diagnostics still write")
    ap.add_argument("-l", "--lbfreq", type=int, default=0,
                    help="dynamic load balancing every N steps: under "
                         "p-adaptive DG with --npes, repartition by "
                         "active dofs along the SFC (the Charm++ "
                         "migration / Zoltan weighted-HSFC analog)")
    ap.add_argument("--npes", type=int, default=1,
                    help="shard the run over N devices (domain "
                         "decomposition over a jax.sharding.Mesh; the "
                         "Transporter/Partitioner analog)")
    ap.add_argument("--slices", type=int, default=0,
                    help="treat the --npes devices as N hosts x "
                         "(npes/N) cards: hierarchical partitioning "
                         "keeps halo exchange inside a host (NVLink) "
                         "and only region boundaries cross the network "
                         "between hosts")
    ap.add_argument("-u", "--virtualization", type=float, default=0.0,
                    help="overdecomposition parameter in [0,1): cut "
                         "linearLoadDistributor-many chunks, LPT-pack "
                         "them per device (the Charm++ virtualization "
                         "analog; LoadDistributor.cpp:23-90)")
    ap.add_argument("--particles", type=int, default=0,
                    help="seed N passive tracer particles, advect them "
                         "with the flow each step, and write "
                         "<output>.h5part trajectories (the Tracker/"
                         "H5PartWriter analog, src/Particles/"
                         "Tracker.hpp)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="print the per-phase wall-clock table at the "
                         "end (the reference Main's timer printout)")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a jax.profiler on-device trace to this "
                         "directory (TensorBoard; Projections analog)")
    args = ap.parse_args(argv)
    if args.checkpoint_dir is None:
        # run-scoped default: ride the field-output basename (the
        # reference writes its checkpoint tree under the run dir too);
        # a bare `restart/` at the invoking CWD was repo-litter
        args.checkpoint_dir = args.output + ".restart"

    import numpy as np

    from .base.profiler import PhaseProfiler, jax_trace
    from .control.config import load_inciter, build_inciter, apply_t0ref
    from .io import read_mesh, write_exodus, DiagWriter

    prof = PhaseProfiler()
    args._prof = prof
    cfg = load_inciter(open(args.control).read())
    with prof.phase("mesh read"):
        mesh = read_mesh(args.input)
    if args.verbose:
        print(f"quinoa_tpu inciter: {cfg.title!r}")
        print(f"  mesh: {mesh.nnode} nodes, {mesh.nelem} tets")
        print(f"  scheme={cfg.scheme} pde={cfg.pde} problem={cfg.problem}"
              + (f" npes={args.npes}" if args.npes > 1 else ""))

    if cfg.t0ref and cfg.amr_initial:
        n0 = mesh.nelem
        with prof.phase("t0ref"):
            mesh = apply_t0ref(cfg, mesh)
        if args.verbose:
            print(f"  t0ref: {n0} -> {mesh.nelem} tets")

    # Hilbert element reorder: the locality pass behind the gathers
    # (the reference's Sorter/Reorder analog, src/Inciter/Sorter.cpp) —
    # semantically invisible (fields and outputs follow the reordered
    # mesh consistently)
    with prof.phase("reorder"):
        from .mesh.reorder import hilbert_element_reorder

        mesh, eorder = hilbert_element_reorder(mesh)
        # field output is expressed in the INPUT file's element order
        # (exodiff-comparable against external baselines): gather-side
        # writes un-permute with this, device-local piece writes
        # translate their elem number maps through it
        args._eorder = eorder

    if args.verbose:
        # setup-time mesh statistics echo + PDF dump
        # (Transporter::stat/pdfstat, Transporter.cpp:735-846)
        from .mesh.stats import (mesh_statistics, format_mesh_statistics,
                                 write_mesh_pdfs)

        if args.npes > 1:
            from .parallel.partition import partition_elements

            parts = partition_elements(mesh.coords, mesh.inpoel,
                                       args.npes, cfg.partitioner)
            chunks = np.bincount(parts, minlength=args.npes)
        else:
            chunks = [mesh.nelem]
        mstats = mesh_statistics(mesh, chunks)
        print(format_mesh_statistics(mstats))
        write_mesh_pdfs(mstats)

    if args.npes > 1 or args.virtualization > 0.0:
        # npes 1 with -u still exercises the overdecomposed SPMD path
        # (the reference's asynclogic sweep includes 1-PE
        # virtualization, SlotCyl/asynclogic/CMakeLists.txt:4-63)
        return _run_inciter_spmd(args, cfg, mesh)

    with prof.phase("solver build"):
        solver, diag = build_inciter(cfg, mesh)
        state = solver.initial_state(t0=cfg.t0)
    if args.restart:
        from .inciter.checkpoint import load_checkpoint

        state, ck = load_checkpoint(args.restart, type(state))
        if args.verbose:
            print(f"  restarted from {args.restart} at it={int(state.it)} "
                  f"t={float(state.t):.6e}")
    dw = DiagWriter(args.diag, ncomp=solver.system.ncomp,
                    fmt=cfg.diag_format, precision=cfg.diag_precision)

    cg_scheme = cfg.scheme in ("diagcg", "alecg")
    if getattr(args, "lbfreq", 0):
        print("  note: --lbfreq has no effect on single-device runs "
              "(load balancing needs --npes > 1)", file=sys.stderr)
    pt = _make_particle_tracking(args, cfg, mesh, solver.system)
    _particles_write(pt, float(state.t))
    amr_base = None  # adaptive-dtref base mesh + its current refinement
    amr_rmap = None
    t0 = time.perf_counter()
    it = int(state.it)  # nonzero when restarted from a checkpoint
    from .base.profiler import jax_trace as _jt
    from .io.iothread import AsyncWriter
    aw = AsyncWriter(enabled=not args.sync_io)
    with _jt(args.trace_dir), _Preempt() as pre:
        while it < cfg.nstep and float(state.t) < cfg.term:
            tprev = float(state.t)
            with prof.phase("timestep"):
                state = solver.step(state)
                it = int(state.it)
            if pt is not None:
                with prof.phase("particles"):
                    _particles_step(pt, state, tprev)
            # diagnostics BEFORE any same-step dtref remesh: the reference
            # writes the diag row for step `it`, then refines going into the
            # next step (its dtref baselines show the pre-refinement row at
            # the final step).
            if it % cfg.diag_interval == 0:
              with prof.phase("diagnostics"):
                row = diag.compute(state)
                if isinstance(row, tuple):
                    l2sol, l2err, linferr = row
                    dw.write(it, float(state.t), float(state.dt), l2sol, l2err,
                             linferr)
                else:
                    dw.write(it, row.t, row.dt, row.l2sol, row.l2err, row.linferr)
            if cfg.dtref and cfg.dtfreq and it % cfg.dtfreq == 0 \
                    and it < cfg.nstep:
                import dataclasses as _dc
                import jax.numpy as jnp

                from .control.config import build_inciter as _rebuild

                ndof = None if cg_scheme else solver.geom.ndof
                changed, mesh2, amr_base, amr_rmap, u2 = _dtref_remesh(
                    cfg, mesh, amr_base, amr_rmap, np.asarray(state.u),
                    cg_scheme, solver.system.ncomp, ndof,
                )
                if changed:
                    mesh = mesh2
                    args._eorder = None
                    _particles_remesh(pt, mesh)
                    solver, diag = _rebuild(cfg, mesh)
                    st = solver.initial_state(t0=float(state.t))
                    state = _dc.replace(st, u=jnp.asarray(u2), it=state.it,
                                        dt=state.dt)
                    if args.verbose:
                        print(f"  dtref @it={it}: -> {mesh.nelem} tets")
            if args.verbose and it % cfg.ttyi == 0:
                print(f"  it={it} t={float(state.t):.6e} dt={float(state.dt):.6e}")
            if it % cfg.field_interval == 0 and not args.benchmark:
                with prof.phase("field output"):
                    # enqueue on the I/O worker: state/mesh are immutable
                    # snapshots, so stepping continues under the write
                    aw.submit(lambda it=it, solver=solver, state=state,
                              mesh=mesh,
                              eo=getattr(args, "_eorder", None):
                              _write_fields(args.output, it, cfg, solver,
                                            state, mesh,
                                            pieces=args.pieces, eorder=eo))
                _particles_write(pt, float(state.t))
            if (args.rsfreq and it % args.rsfreq == 0) or pre.flag:
                from .inciter.checkpoint import save_checkpoint

                with prof.phase("checkpoint"):
                    save_checkpoint(args.checkpoint_dir, state,
                                    {"it": it, "t": float(state.t)})
            if pre.flag:
                print(f"  preempted at it={it}: checkpoint written to "
                      f"{args.checkpoint_dir}; resume with --restart")
                break
    dw.close()
    if pt is not None:
        pt["writer"].close()
    if args.verbose:
        wall = time.perf_counter() - t0
        print(f"  done: {it} steps, t={float(state.t):.6e}, {wall:.2f}s")
    if not args.benchmark:
        aw.submit(lambda: _write_fields(args.output, it, cfg, solver,
                                        state, mesh, pieces=args.pieces,
                                        eorder=getattr(args, "_eorder",
                                                       None)))
    aw.close()
    if args.profile:
        print(prof.table())
    return 0


def _dtref_remesh(cfg, mesh, amr_base, amr_rmap, u_host, cg_scheme, ncomp,
                  ndof):
    """One during-timestep AMR decision on host state.

    u_host is the GLOBAL solution ((C, nnode) nodal for CG schemes,
    (C*ndof, nelem) modal for DG).  Returns
    (changed, mesh, amr_base, amr_rmap, u_transferred-or-None) — shared
    by the single-device and SPMD drivers (under SPMD a `changed` result
    triggers a resharding event, the reference's migration analog).
    """
    import numpy as np

    from .amr import refine_mesh, tag_edges_by_error, uniform_refine
    from .amr.refine import (
        transfer_cg, transfer_dg,
        transfer_cg_derefine, transfer_dg_derefine, RefineMap,
    )

    if cfg.dtref_uniform:
        # compounding uniform refinement (the reference's dtref_uniform
        # regression behavior)
        mesh2, rmap = uniform_refine(mesh)
        if mesh2.nelem > mesh.nelem:
            if cg_scheme:
                u2 = transfer_cg(rmap, u_host)
            else:
                u2 = transfer_dg(rmap, u_host, ncomp, ndof)
            return True, mesh2, amr_base, amr_rmap, u2
        return False, mesh, amr_base, amr_rmap, None

    if cfg.amr_maxlevels > 1:
        # incremental multi-level cycle (amr/adapt.py): refine from the
        # CURRENT mesh, coarsen sibling groups below tol_derefine
        from .amr.adapt import dtref_adapt

        if cg_scheme:
            uerr = u_host
            u_in = u_host
        else:
            from .pde.dg import dg_cell_avg
            import jax.numpy as jnp

            avg = np.asarray(dg_cell_avg(jnp.asarray(u_host), ncomp, ndof))
            unod = np.zeros((avg.shape[0], mesh.nnode))
            cnt = np.zeros(mesh.nnode)
            for a in range(4):
                np.add.at(cnt, mesh.inpoel[:, a], 1.0)
                for c in range(avg.shape[0]):
                    np.add.at(unod[c], mesh.inpoel[:, a], avg[c])
            unod /= np.maximum(cnt, 1.0)
            uerr = unod
            u_in = u_host
        changed, mesh2, chain, u2 = dtref_adapt(
            mesh, amr_base, uerr, u_in, cg_scheme, ncomp, ndof,
            method=cfg.amr_error, tol_refine=cfg.amr_tol,
            tol_derefine=cfg.amr_tolderef, maxlevels=cfg.amr_maxlevels,
        )
        # the chain rides the amr_base slot; amr_rmap is unused here
        return changed, mesh2, chain, None, (u2 if changed else None)

    # adaptive dtref, one level above the base mesh: retag every dtfreq
    # steps and rebuild refine_mesh(base, tags).  Regions no longer
    # tagged coarsen automatically (the transfer between two sibling
    # refinements of the base is the derefine transfer: identical
    # parents copy, refined parents inherit the parent mean / midpoint
    # interpolant, collapsed parents get the conservative child average).
    if amr_base is None:
        amr_base = mesh
        amr_rmap = RefineMap(
            mid_edges=np.zeros((0, 2), np.int64),
            parent=np.arange(mesh.nelem),
            nnode_old=mesh.nnode,
        )
    nb = amr_base.nnode  # base nodes prefix every refinement
    if cg_scheme:
        uerr = u_host[:, :nb]
        vol_cur = None
    else:
        from .pde.dg import dg_cell_avg
        import jax.numpy as jnp

        avg = np.asarray(dg_cell_avg(jnp.asarray(u_host), ncomp, ndof))
        unod = np.zeros((avg.shape[0], mesh.nnode))
        cnt = np.zeros(mesh.nnode)
        for a in range(4):
            np.add.at(cnt, mesh.inpoel[:, a], 1.0)
            for c in range(avg.shape[0]):
                np.add.at(unod[c], mesh.inpoel[:, a], avg[c])
        unod /= np.maximum(cnt, 1.0)
        uerr = unod[:, :nb]
        from .mesh.geometry import tet_geometry

        J, _ = tet_geometry(mesh.coords, mesh.inpoel)
        vol_cur = J / 6.0
    tags = tag_edges_by_error(
        amr_base, uerr, method=cfg.amr_error, tol=cfg.amr_tol,
    )
    mesh2, rmap2 = refine_mesh(amr_base, tags)
    cur_keys = {tuple(e) for e in np.sort(amr_rmap.mid_edges, 1).tolist()}
    new_keys = {tuple(e) for e in np.sort(rmap2.mid_edges, 1).tolist()}
    if new_keys != cur_keys:
        if cg_scheme:
            u2 = transfer_cg_derefine(amr_rmap, rmap2, u_host)
        else:
            u2 = transfer_dg_derefine(
                amr_base, amr_rmap, rmap2, u_host, vol_cur, ncomp, ndof)
        return True, mesh2, amr_base, rmap2, u2
    return False, mesh, amr_base, amr_rmap, None


def _hs(x):
    """Host value of a time-marching scalar (works for both the
    single-device 0-d scalars and the SPMD (S,) shard-axis copies)."""
    import numpy as _np

    return _np.asarray(x).ravel()[0]


def _make_particle_tracking(args, cfg, mesh, system):
    """(tracker, xp, ep, writer, velocity args fn) or None.

    Velocity source by configuration: analytic velocity field for
    transport problems; interpolated nodal momentum/density for CG
    compflow; containing-cell mean for DG compflow.
    """
    if not getattr(args, "particles", 0):
        return None
    from .io.h5part import H5PartWriter
    from .particles import ParticleTracker, seed_particles
    from .particles.tracker import (analytic_velocity, cell_velocity,
                                    nodal_velocity)

    if cfg.pde == "transport":
        vel = analytic_velocity(system.problem)
        vargs = lambda state: ()
    elif cfg.pde == "compflow" and cfg.scheme in ("diagcg", "alecg"):
        vel = nodal_velocity()
        vargs = lambda state: (state.u,)
    elif cfg.pde == "compflow":
        from .control.config import _SCHEME_NDOF

        K = _SCHEME_NDOF.get(cfg.scheme, 4)
        vel = cell_velocity(5, K)
        vargs = lambda state: (state.u,)
    else:
        raise SystemExit(
            "--particles supports transport and compflow runs")
    tracker = ParticleTracker(mesh, vel)
    xp, ep = seed_particles(mesh, args.particles)
    import jax.numpy as jnp

    writer = H5PartWriter(args.output + ".h5part")
    return dict(tracker=tracker, xp=jnp.asarray(xp),
                ep=jnp.asarray(ep), writer=writer, vargs=vargs)


def _particles_remesh(pt, mesh):
    """Rebuild the tracker tables on a refined mesh: keep positions,
    re-home each particle by nearest centroid + the neighbor walk."""
    if pt is None:
        return
    import jax.numpy as jnp
    import numpy as np

    from .particles import ParticleTracker
    from .particles.tracker import locate, make_tracker_geom

    tr = pt["tracker"]
    tr.geom = make_tracker_geom(mesh)
    tr._advance = None  # retrace lazily via jit below
    import jax

    tr._advance = jax.jit(tr._advance_impl)
    xp = np.asarray(pt["xp"])
    cent = np.asarray(tr.geom.cent)
    # nearest centroid as the walk seed (host-side, remesh-rate only)
    d2 = ((cent[:, None, :] - xp[:, :, None]) ** 2).sum(axis=0)
    ep = jnp.asarray(np.argmin(d2, axis=1).astype(np.int32))
    for _ in range(4):
        ep = locate(tr.geom, jnp.asarray(xp), ep, hops=4)
    pt["ep"] = ep


def _particles_step(pt, state, tprev):
    if pt is None:
        return
    import numpy as np

    dt = float(np.asarray(state.dt).ravel()[0])
    pt["xp"], pt["ep"] = pt["tracker"].advance(
        pt["xp"], pt["ep"], tprev, dt, *pt["vargs"](state))


def _particles_write(pt, t):
    if pt is None:
        return
    import numpy as np

    pt["writer"].write(np.asarray(pt["xp"]).T, time=t)


def _run_inciter_spmd(args, cfg, mesh):
    """Distributed inciter run: shard_map solvers over a 1-D device mesh.

    The production parallel path (the reference's executable is parallel
    by construction, Transporter.cpp:278-352): partition -> SPMD solver
    -> ownership-masked diag reductions -> gathered field/checkpoint
    output; a dtref remesh triggers a resharding event (gather ->
    retag/refine/transfer -> repartition -> rebuild sharded solver).
    """
    import dataclasses as _dc
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from .control.config import build_inciter_spmd
    from .io import DiagWriter
    from .parallel.shard import gather_global_field

    hierarchy = None
    if getattr(args, "slices", 0) and args.slices > 1:
        if args.npes % args.slices:
            raise SystemExit("--npes must be a multiple of --slices")
        hierarchy = (args.slices, args.npes // args.slices)
    solver = build_inciter_spmd(
        cfg, mesh, args.npes,
        virtualization=getattr(args, "virtualization", 0.0),
        hierarchy=hierarchy)
    cg_scheme = cfg.scheme in ("diagcg", "alecg")

    def gather_u(state, from_solver=None):
        # from_solver pins the solver whose shard metadata matches the
        # state: async writes and LB/dtref rebuilds snapshot it so a
        # rebuild between enqueue and execution can't mix a NEW
        # partition's tables with an OLD state
        sv = from_solver if from_solver is not None else solver
        if cg_scheme:
            sh = sv.sharded
            shcg = sh.cg if hasattr(sh, "cg") else sh
            return gather_global_field(shcg, state.u)
        return sv.gather_global(state)

    def scatter_u(solver2, u_glob):
        """Stacked per-shard u from a global field (pads/ghosts read
        through clipped ids; ghost slots hold the owner's values)."""
        sh = solver2.sharded
        if cg_scheme:
            shcg = sh.cg if hasattr(sh, "cg") else sh
            ids = np.maximum(np.asarray(shcg.gids), 0)
        else:
            ids = np.maximum(np.asarray(sh.eglobal), 0)
        return jnp.asarray(np.stack([u_glob[:, ids[s]] for s in
                                     range(ids.shape[0])]))

    state = solver.initial_state(t0=cfg.t0)
    if args.restart:
        from .inciter.checkpoint import load_checkpoint_sharded

        st, ck = load_checkpoint_sharded(args.restart, type(state),
                                         mesh=solver.mesh)
        state = jax.tree_util.tree_map(
            lambda a, b: (
                a if a.shape == b.shape
                and getattr(a, "sharding", None) == b.sharding
                else jax.device_put(jnp.asarray(a), b.sharding)
            ),
            st, state,
        )
        if args.verbose:
            print(f"  restarted from {args.restart} at it={int(_hs(state.it))}")
    dw = DiagWriter(args.diag, ncomp=solver.system.ncomp,
                    fmt=cfg.diag_format, precision=cfg.diag_precision)

    amr_base = None
    amr_rmap = None
    prof = getattr(args, "_prof", None)
    if prof is None:
        from .base.profiler import PhaseProfiler

        prof = PhaseProfiler()
    t0 = time.perf_counter()
    it = int(_hs(state.it))
    from .base.profiler import jax_trace as _jt
    from .io.iothread import AsyncWriter

    aw = AsyncWriter(enabled=not getattr(args, "sync_io", False))
    with _jt(getattr(args, "trace_dir", None)), _Preempt() as pre:
        while it < cfg.nstep and float(_hs(state.t)) < cfg.term:
            with prof.phase("timestep"):
                state = solver.step(state)
                it = int(_hs(state.it))
            if it % cfg.diag_interval == 0:
              with prof.phase("diagnostics"):
                l2sol, l2err, linferr = solver.diagnostics(state)
                dw.write(it, float(_hs(state.t)), float(_hs(state.dt)), l2sol, l2err,
                         linferr)
            if cfg.dtref and cfg.dtfreq and it % cfg.dtfreq == 0 \
                    and it < cfg.nstep:
                ndof = None if cg_scheme else solver.sharded.geom.ndof
                changed, mesh2, amr_base, amr_rmap, u2 = _dtref_remesh(
                    cfg, mesh, amr_base, amr_rmap, gather_u(state),
                    cg_scheme, solver.system.ncomp, ndof,
                )
                if changed:
                  with prof.phase("resharding"):
                    mesh = mesh2
                    args._eorder = None
                    solver = build_inciter_spmd(
                        cfg, mesh, args.npes,
                        virtualization=getattr(args, "virtualization", 0.0),
                        hierarchy=hierarchy)
                    st = solver.initial_state(t0=float(_hs(state.t)))
                    unew = jax.device_put(
                        scatter_u(solver, u2).astype(st.u.dtype),
                        st.u.sharding,
                    )
                    state = _dc.replace(st, u=unew, it=state.it, dt=state.dt)
                    if args.verbose:
                        print(f"  dtref @it={it}: -> {mesh.nelem} tets "
                              f"(resharded over {args.npes})")
            if getattr(args, "lbfreq", 0) and it % args.lbfreq == 0 \
                    and it < cfg.nstep and getattr(solver, "pref", False) \
                    and not getattr(args, "slices", 0):
                # dynamic LB by active dofs (ndofel): without -u,
                # repartition along the weighted SFC; under -u, keep
                # chunk membership and re-LPT-pack chunks to devices
                # (the literal chare-migration analog).  Migrates u AND
                # the sticky ndofel state.
                with prof.phase("load balancing"):
                    nd = _gather_ndofel(solver, state)
                    virt = getattr(args, "virtualization", 0.0)
                    if virt > 0.0:
                        # signature the resulting chunk->device PACKING,
                        # not the raw weights: ndofel drifts nearly
                        # every adaptation while the LPT assignment is
                        # usually stable — a no-op migration must not
                        # pay a rebuild + recompile
                        import math as _math

                        from .base.load import linear_load_distributor
                        from .parallel.overdecomp import lpt_assign
                        from .parallel.partition import partition_for

                        _, nchare = linear_load_distributor(
                            virt, mesh.nelem, args.npes)
                        cpd = max(_math.ceil(nchare / args.npes), 1)
                        nchunk = cpd * args.npes
                        ep_ch = partition_for(mesh.coords, mesh.inpoel,
                                              nchunk, cfg.partitioner)
                        costs = np.bincount(ep_ch, weights=nd,
                                            minlength=nchunk)
                        sig = lpt_assign(costs, args.npes,
                                         cpd).tobytes()
                        kw = dict(virtualization=virt,
                                  elem_weights=nd.astype(np.float64))
                    else:
                        from .parallel.partition import (
                            partition_elements,
                        )

                        epart = partition_elements(
                            mesh.coords, mesh.inpoel, args.npes,
                            weights=nd.astype(np.float64))
                        sig = epart.tobytes()
                        kw = dict(epart=epart)
                    if getattr(args, "_lb_sig", None) != sig:
                        args._lb_sig = sig
                        u2 = gather_u(state)
                        solver = build_inciter_spmd(
                            cfg, mesh, args.npes, hierarchy=hierarchy,
                            **kw)
                        st = solver.initial_state(t0=float(_hs(state.t)))
                        unew = jax.device_put(
                            scatter_u(solver, u2).astype(st.u.dtype),
                            st.u.sharding)
                        ids = np.maximum(
                            np.asarray(solver.sharded.eglobal), 0)
                        ndnew = jax.device_put(
                            jnp.asarray(np.stack([nd[ids[s]] for s in
                                                  range(ids.shape[0])])
                                        .astype(np.int32)),
                            st.ndofel.sharding)
                        state = _dc.replace(st, u=unew, ndofel=ndnew,
                                            it=state.it, dt=state.dt)
                        if args.verbose:
                            own = np.asarray(solver.sharded.owned) > 0
                            eg = np.asarray(solver.sharded.eglobal)
                            per = [float(nd[eg[s][own[s]]].sum())
                                   for s in range(args.npes)]
                            print(f"  lb @it={it}: active-dof balance "
                                  f"{min(per):.0f}..{max(per):.0f}")
            if args.verbose and it % cfg.ttyi == 0:
                print(f"  it={it} t={float(_hs(state.t)):.6e} dt={float(_hs(state.dt)):.6e}")
            if it % cfg.field_interval == 0 \
                    and not getattr(args, "benchmark", False):
                aw.submit(lambda it=it, solver=solver, state=state,
                          mesh=mesh, gu=gather_u,
                          eo=getattr(args, "_eorder", None):
                          _write_fields_spmd(args, it, cfg, solver, state,
                                             mesh, gu, cg_scheme,
                                             eorder=eo))
            if (args.rsfreq and it % args.rsfreq == 0) or pre.flag:
                from .inciter.checkpoint import save_checkpoint_sharded

                save_checkpoint_sharded(args.checkpoint_dir, state,
                                        {"it": it, "t": float(_hs(state.t)),
                                         "npes": args.npes})
            if pre.flag:
                print(f"  preempted at it={it}: checkpoint written to "
                      f"{args.checkpoint_dir}; resume with --restart")
                break
    dw.close()
    if args.verbose:
        wall = time.perf_counter() - t0
        print(f"  done: {it} steps, t={float(_hs(state.t)):.6e}, {wall:.2f}s")
    if not getattr(args, "benchmark", False):
        aw.submit(lambda: _write_fields_spmd(args, it, cfg, solver, state,
                                             mesh, gather_u, cg_scheme,
                                             eorder=getattr(args,
                                                            "_eorder",
                                                            None)))
    aw.close()
    if getattr(args, "profile", False):
        print(prof.table())
    return 0


def _gather_ndofel(solver, state):
    """Global (E,) active-dof counts from the owned shard copies."""
    import numpy as np

    nd = np.asarray(state.ndofel)
    eg = np.asarray(solver.sharded.eglobal)
    owned = np.asarray(solver.sharded.owned) > 0
    out = np.zeros(solver.sharded.nelem_global, dtype=np.int32)
    for s in range(solver.sharded.nshard):
        m = owned[s]
        out[eg[s][m]] = nd[s][m]
    return out


def _write_fields_spmd(args, it, cfg, solver, state, mesh, gather_u,
                       cg_scheme, eorder=None):
    import numpy as np

    from .inciter.fieldout import plot_fields
    from .io import write_exodus, write_exodus_pieces

    # per-shard writes: each piece file is produced from its own
    # device-local buffer (state.u.addressable_shards) — no global
    # field gather, the MeshWriter file-per-chare analog at scale.
    # Supported piece counts: npes (one file per device) and, under
    # overdecomposition, cpd*npes (one file per CHARE, the reference's
    # MeshWriter.hpp:33-100 contract); anything else gathers.
    if _write_pieces_per_shard(args, it, cfg, solver, state, mesh,
                               cg_scheme, eorder=eorder):
        return

    u = gather_u(state, solver)
    fields = None
    elem_fields = None
    if cg_scheme:
        fields = plot_fields(cfg.pde, solver.system, u, mesh.coords.T,
                             float(_hs(state.t)))
    else:
        import jax.numpy as jnp

        from .pde.dg import dg_cell_avg

        avg = np.asarray(dg_cell_avg(jnp.asarray(u), solver.system.ncomp,
                                     solver.sharded.geom.ndof))
        cen = mesh.coords[mesh.inpoel].mean(axis=1).T
        elem_fields = plot_fields(cfg.pde, solver.system, avg, cen,
                                  float(_hs(state.t)))
    mesh, elem_fields = _orig_order(mesh, elem_fields, eorder)
    if args.pieces > 1:
        from .parallel.partition import partition_elements

        parts = partition_elements(mesh.coords, mesh.inpoel, args.pieces,
                                   algorithm=cfg.partitioner)
        write_exodus_pieces(args.output, mesh, parts, node_fields=fields,
                            elem_fields=elem_fields, time=float(_hs(state.t)),
                            it=it)
    else:
        write_exodus(f"{args.output}.e-s.{it}.exo", mesh,
                     node_fields=fields, elem_fields=elem_fields,
                     time=float(_hs(state.t)))


def _write_pieces_per_shard(args, it, cfg, solver, state, mesh,
                            cg_scheme, eorder=None):
    """One ExodusII piece per device (--pieces == npes) or per chare
    (--pieces == cpd*npes under -u), valued from the owning device's
    buffer.

    The piece meshes come from the deterministic host partition (same
    partitioner calls the shard/overdecomp builders made); values come
    from each device's addressable shard without assembling a global
    field.  Returns False for piece counts that need a gather.
    """
    import numpy as np

    from .inciter.fieldout import plot_fields
    from .io import write_exodus
    from .io.pieces import extract_piece, piece_path
    from .parallel.partition import partition_elements

    if args.pieces <= 1:
        return False
    ov = getattr(solver, "overdecomp", None)
    if ov is not None:
        nchunk = ov.npes * ov.cpd
        chunk_parts = partition_elements(mesh.coords, mesh.inpoel, nchunk,
                                         algorithm=cfg.partitioner)
        devof = np.empty(nchunk, dtype=np.int64)
        for d, row in enumerate(ov.assign):
            for c in row:
                devof[c] = d
        if args.pieces == nchunk:
            piece_parts = chunk_parts            # file per chare
            dev_of_piece = devof
        elif args.pieces == args.npes:
            piece_parts = devof[chunk_parts]     # file per device
            dev_of_piece = np.arange(args.npes)
        else:
            return False
    else:
        if args.pieces != args.npes:
            return False
        piece_parts = partition_elements(mesh.coords, mesh.inpoel,
                                         args.npes,
                                         algorithm=cfg.partitioner)
        dev_of_piece = np.arange(args.npes)

    shards = sorted(state.u.addressable_shards,
                    key=lambda sh: sh.index[0].start or 0)
    sh = solver.sharded
    t = float(_hs(state.t))

    def g2l_owned(gids_d, owned_d):
        """global id -> local position, preferring OWNED copies (ghost
        slots hold the previous stage's values after the final RK
        stage; under -u a device may also hold several copies)."""
        g2l = {}
        for i2, g in enumerate(gids_d):
            if g >= 0 and int(g) not in g2l:
                g2l[int(g)] = i2
        for i2, g in enumerate(gids_d):
            if g >= 0 and owned_d[i2] > 0:
                g2l[int(g)] = i2
        return g2l

    for p in range(args.pieces):
        lm, nmap, emap = extract_piece(mesh, piece_parts, p)
        d = int(dev_of_piece[p])
        u_s = np.asarray(shards[d].data)[0]  # (C, Nl) / (C*K, El)
        if cg_scheme:
            shcg = sh.cg if hasattr(sh, "cg") else sh
            g2l = g2l_owned(np.asarray(shcg.gids)[d],
                            np.asarray(shcg.owned)[d])
            pos = np.array([g2l[int(n)] for n in nmap], dtype=np.int64)
            vals = u_s[:, pos]
            nf = plot_fields(cfg.pde, solver.system, vals,
                             mesh.coords[nmap].T, t)
            ef = None
        else:
            import jax.numpy as jnp

            from .pde.dg import dg_cell_avg

            g2l = g2l_owned(np.asarray(sh.eglobal)[d],
                            np.asarray(sh.owned)[d])
            pos = np.array([g2l[int(e)] for e in emap], dtype=np.int64)
            avg = np.asarray(dg_cell_avg(
                jnp.asarray(u_s), solver.system.ncomp,
                sh.geom.ndof))[:, pos]
            cen = mesh.coords[mesh.inpoel[emap]].mean(axis=1).T
            ef = plot_fields(cfg.pde, solver.system, avg, cen, t)
            nf = None
        emap_out = emap if eorder is None else eorder[emap]
        write_exodus(piece_path(args.output, it, args.pieces, p), lm,
                     node_fields=nf, elem_fields=ef, time=t,
                     node_num_map=nmap, elem_num_map=emap_out)
    return True


def _orig_order(mesh, elem_fields, eorder):
    """Re-express (mesh, element fields) in the original input-file
    element order (eorder is new->old from hilbert_element_reorder:
    original id of current element i is eorder[i])."""
    import numpy as np

    from .mesh.unsmesh import UnsMesh

    if eorder is None:
        return mesh, elem_fields
    inv = np.argsort(eorder)
    out = UnsMesh(coords=mesh.coords, inpoel=mesh.inpoel[inv])
    out.bface = dict(mesh.bface)
    out.bnode = mesh.bnode
    ef = elem_fields
    if elem_fields is not None:
        ef = {k: np.asarray(v)[..., inv] for k, v in elem_fields.items()}
    return out, ef


def _write_fields(base, it, cfg, solver, state, mesh, pieces=0,
                  eorder=None):
    import numpy as np
    from .io import write_exodus, write_exodus_pieces

    from .inciter.fieldout import plot_fields

    u = np.asarray(state.u)
    fields = None
    elem_fields = None
    if cfg.scheme in ("diagcg", "alecg"):
        # nodal plot variables with the reference's names
        fields = plot_fields(cfg.pde, solver.system, u, mesh.coords.T,
                             float(_hs(state.t)))
    else:
        from .pde.dg import dg_cell_avg
        import jax.numpy as jnp

        avg = np.asarray(
            dg_cell_avg(jnp.asarray(u), solver.system.ncomp, solver.geom.ndof)
        )
        # element (cell-average) plot variables, as the reference's DG
        # MeshWriter output does (analytic vars sampled at centroids)
        cen = mesh.coords[mesh.inpoel].mean(axis=1).T
        exact_mean = None
        if cfg.pde == "transport":
            from .pde.dg import dg_initialize

            ua = np.asarray(dg_initialize(solver.system, solver.geom,
                                          float(_hs(state.t))))
            exact_mean = ua.reshape(solver.system.ncomp,
                                    solver.geom.ndof, -1)[:, 0, :]
        elem_fields = plot_fields(cfg.pde, solver.system, avg, cen,
                                  float(_hs(state.t)), exact_mean=exact_mean)
    mesh, elem_fields = _orig_order(mesh, elem_fields, eorder)
    if pieces > 1:
        from .parallel.partition import partition_elements

        parts = partition_elements(mesh.coords, mesh.inpoel, pieces,
                                   algorithm=cfg.partitioner)
        write_exodus_pieces(base, mesh, parts, node_fields=fields,
                            elem_fields=elem_fields, time=float(_hs(state.t)),
                            it=it)
    else:
        write_exodus(f"{base}.e-s.{it}.exo", mesh, node_fields=fields,
                     elem_fields=elem_fields, time=float(_hs(state.t)))


def _cmd_walker(argv):
    ap = argparse.ArgumentParser(prog="quinoa_tpu walker")
    ap.add_argument("-c", "--control", required=True)
    ap.add_argument("--stat", default="stat.txt")
    ap.add_argument("--seed", type=int, default=None,
                    help="RNG seed (default: the deck's rngs seed, or 0)")
    ap.add_argument("--npes", type=int, default=1,
                    help="shard the particle ensemble over N devices "
                         "(pure data parallelism; moment psums are "
                         "inserted by XLA — the Distributor/Collector "
                         "analog)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from .control.config import load_walker, build_walker
    from .io import TxtStatWriter
    from .statistics.stats import estimate_moments

    cfg = load_walker(open(args.control).read())
    seed = args.seed if args.seed is not None else (cfg.rng_seed or 0)
    pmesh = None
    if args.npes > 1:
        import jax
        import numpy as np
        from jax.sharding import Mesh

        devs = jax.devices()
        if len(devs) < args.npes:
            raise SystemExit(
                f"--npes {args.npes} but only {len(devs)} devices")
        pmesh = Mesh(np.array(devs[:args.npes]), ("par",))
    w = build_walker(cfg, seed=seed, mesh=pmesh)
    if args.verbose:
        print(f"quinoa_tpu walker: {cfg.title!r}")
        print(f"  npar={cfg.npar} dt={cfg.dt} systems="
              f"{[type(s).__name__ for s in w.systems]}")

    sw = TxtStatWriter(args.stat, cfg.ordinary, cfg.central,
                       fmt=cfg.stat_format,
                       precision=cfg.stat_precision)
    P = w.initialize()
    nsteps = min(cfg.nstep, int(cfg.term / cfg.dt + 1e-9))
    done = 0

    def dump_pdfs(t=0.0):
        from .io import write_pdf_txt, write_pdf_gmsh, write_pdf_exodus
        from functools import partial

        writers = {"txt": (partial(write_pdf_txt, fmt=cfg.pdf_format,
                                   precision=cfg.pdf_precision), "txt"),
                   "gmshtxt": (partial(write_pdf_gmsh,
                                       centering=cfg.pdf_centering),
                               "msh"),
                   "exodusii": (write_pdf_exodus, "exo")}
        fn, ext = writers.get(
            cfg.pdf_filetype,
            (partial(write_pdf_txt, fmt=cfg.pdf_format,
                     precision=cfg.pdf_precision), "txt"))
        for name, term, bins, extents, central in cfg.pdfs:
            pdf = w.pdf(P, term, bins, extents, central=central)
            # PDFPolicy `multiple`: time-stamped filename per output
            # (Distributor.cpp:405-411); `overwrite` (default) rewrites
            base = (f"{name}_{t:g}" if cfg.pdf_policy == "multiple"
                    else name)
            fn(f"{base}.{ext}", pdf)

    while done < nsteps:
        chunk = min(cfg.stat_interval, nsteps - done)
        P, _ = w.run(chunk, P=P)
        done += chunk
        mom = estimate_moments(P, w.offsets, cfg.ordinary, cfg.central)
        sw.write(done, done * cfg.dt, {k: float(v) for k, v in mom.items()})
        if cfg.pdf_interval and done % cfg.pdf_interval < cfg.stat_interval:
            dump_pdfs(done * cfg.dt)
        if args.verbose and done % cfg.ttyi == 0:
            print(f"  it={done} t={done * cfg.dt:.6e}")
    if cfg.pdfs:
        dump_pdfs(done * cfg.dt)
    sw.close()
    return 0


def _cmd_meshconv(argv):
    ap = argparse.ArgumentParser(prog="quinoa_tpu meshconv")
    ap.add_argument("-i", "--input", required=True, nargs="+",
                    help="input mesh, or several exodus PIECES "
                         "(out.e-s.<it>.<N>.<p>) to join into one file")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--netcdf4", action="store_true",
                    help="write exodus output in the HDF5-based "
                         "netCDF-4 layout instead of NetCDF-3 classic")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from .io import read_mesh, write_mesh, detect_format

    if len(args.input) > 1:
        # join partitioned pieces back into one mesh + fields
        from .io import join_exodus_pieces, write_exodus

        mesh, nf, ef, t = join_exodus_pieces(args.input)
        if args.verbose:
            print(f"meshconv: joined {len(args.input)} pieces -> "
                  f"{args.output}: {mesh.nnode} nodes, {mesh.nelem} tets, "
                  f"{len(nf)} nodal + {len(ef)} element fields")
        write_exodus(args.output, mesh, node_fields=nf or None,
                     elem_fields=ef or None, time=t,
                     fmt="netcdf4" if args.netcdf4 else "classic")
        return 0

    args.input = args.input[0]
    fmt = detect_format(args.input)
    mesh = read_mesh(args.input, fmt)
    if not mesh.bface and mesh.nelem:
        # no boundary in the input: derive the exterior surface, like
        # the reference's meshconv (shear.exo.std grows a shell block
        # of the 16000 exterior triangles from the block-only input)
        from .mesh.derived import exterior_faces

        mesh.bface[1] = exterior_faces(mesh.inpoel, mesh.nnode)
        mesh.bnode = mesh.bnode_from_bface()
    if args.verbose:
        print(
            f"meshconv: {args.input} ({fmt}) -> {args.output}: "
            f"{mesh.nnode} nodes, {mesh.nelem} tets, "
            f"{sum(len(v) for v in mesh.bface.values())} boundary tris"
        )
    if args.netcdf4:
        from .io import write_exodus as _we

        _we(args.output, mesh, fmt="netcdf4")
    else:
        write_mesh(args.output, mesh)
    return 0


def _cmd_rngtest(argv):
    ap = argparse.ArgumentParser(prog="quinoa_tpu rngtest")
    ap.add_argument("-c", "--control", default=None,
                    help=".q control file (optional; defaults to smallcrush)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="threefry2x32",
                    help="jax PRNG implementation (threefry2x32, rbg, ...)")
    ap.add_argument("--battery", default=None,
                    choices=["smallcrush", "crush", "bigcrush"],
                    help="battery scale (overrides the deck block)")
    args = ap.parse_args(argv)

    from .rngtest import run_battery, SmallCrush, Crush

    #: deck rng keyword -> jax PRNG impl.  r123_threefry IS jax's
    #: threefry2x32 (same Random123 family); philox has no jax
    #: implementation, so the other hardware-friendly counter-based
    #: generator (rbg) stands in; MKL/RNGSSE are x86 libraries with no
    #: accelerator analog — their deck entries run the default counter RNG so
    #: the reference decks execute end-to-end (COMPONENTS.md §2.8)
    def _impl_of(rngname):
        if rngname.startswith("r123_threefry"):
            return "threefry2x32"
        if rngname.startswith("r123_philox"):
            return "rbg"
        return "threefry2x32"

    name = args.battery
    rngs = None  # [(deck rng name, impl, seed)]
    if args.control:
        from .control.qparser import parse_deck, first

        tree = parse_deck(open(args.control).read())
        rt = first(tree, "rngtest") or tree  # battery block may be at root
        if name is None:
            name = ("bigcrush" if "bigcrush" in rt else
                    "crush" if "crush" in rt else "smallcrush")
        blk = first(rt, name)
        if isinstance(blk, dict) and blk:
            # subject EACH deck rng to the battery (testu01suite.ci:
            # one chare per (rng, test); here one battery run per rng)
            rngs = []
            for rn, opts in blk.items():
                seed = args.seed
                for row in opts if isinstance(opts, list) else []:
                    if isinstance(row, list) and len(row) >= 2 \
                            and row[0] == "seed":
                        seed = int(row[1])
                rngs.append((rn, _impl_of(rn), seed))
    name = name or "smallcrush"
    if not rngs:
        rngs = [(args.impl, args.impl, args.seed)]
    from .rngtest.battery import BigCrush

    battery = (BigCrush if name == "bigcrush"
               else Crush if name == "crush" else SmallCrush)
    any_failed = False
    for rn, impl, seed in rngs:
        results, failed = run_battery(seed=seed, impl=impl,
                                      battery=battery)
        any_failed = any_failed or bool(failed)
        print(f"{name} battery, rng={rn} (impl={impl}), seed={seed}")
        for r in results:
            print(f"  {r.name:20s} p-value {r.pvalue:8.5f}  "
                  f"{'pass' if r.passed else 'FAIL'}")
        print(f"{len(results) - len(failed)}/{len(results)} tests passed")
    return 1 if any_failed else 0


def _cmd_fileconv(argv):
    """Field-file conversion (the reference's fileconv executable,
    src/Main/FileConv.cpp). Its ROOT<->ExodusII half needs the ROOT
    library (absent in this build); the ExodusII side converts between
    the NetCDF-3 classic and netcdf-4/HDF5 layouts, carrying nodal and
    element variables."""
    ap = argparse.ArgumentParser(prog="quinoa_tpu fileconv")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    with open(args.input, "rb") as fh:
        magic = fh.read(4)
    if magic not in (b"CDF\x01", b"CDF\x02", b"\x89HDF"):
        print("fileconv: ROOT field files need the ROOT library, which "
              "is not in this build; only ExodusII inputs are supported",
              file=sys.stderr)
        return 1
    from .io.exodus import (
        read_exodus, read_exodus_fields, read_exodus_elem_fields,
        write_exodus,
    )

    mesh = read_exodus(args.input)
    nnames, ntimes, nvals = read_exodus_fields(args.input)
    enames, etimes, evals = read_exodus_elem_fields(args.input)
    nf = {n: nvals[-1, i] for i, n in enumerate(nnames)} or None
    ef = {n: evals[-1, i] for i, n in enumerate(enames)} or None
    t = float(ntimes[-1]) if len(ntimes) else (
        float(etimes[-1]) if len(etimes) else 0.0)
    fmt = "classic" if magic == b"\x89HDF" else "netcdf4"
    write_exodus(args.output, mesh, node_fields=nf, elem_fields=ef,
                 time=t, fmt=fmt)
    if args.verbose:
        print(f"fileconv: {args.input} -> {args.output} ({fmt}): "
              f"{len(nnames)} nodal + {len(enames)} element fields")
    return 0


_COMMANDS = {
    "inciter": _cmd_inciter,
    "walker": _cmd_walker,
    "meshconv": _cmd_meshconv,
    "rngtest": _cmd_rngtest,
    "fileconv": _cmd_fileconv,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from .base.xlacache import enable_compile_cache

    enable_compile_cache()
    # -H [keyword]: auto-generated control-file keyword help, accepted
    # by every executable (HelpFactory.hpp; Keyword.hpp:90-99)
    if "-H" in argv or "--helpkw" in argv:
        from .control.keywords import format_keyword_help

        i = argv.index("-H" if "-H" in argv else "--helpkw")
        kw = argv[i + 1] if i + 1 < len(argv) \
            and not argv[i + 1].startswith("-") else None
        print(format_keyword_help(kw))
        return 0
    # version/license switches, accepted by every executable (the
    # reference's CmdLine grammar `version`/`license` rules)
    if "--version" in argv:
        from . import __version__

        print(f"quinoa_tpu {__version__} (JAX rebuild of Quinoa; "
              "jax/XLA compute path)")
        return 0
    if "--license" in argv:
        print("quinoa_tpu: an independent JAX implementation of "
              "the Quinoa feature set.\nReference upstream "
              "(github.com/quinoacomputing/quinoa) is BSD-3-Clause.")
        return 0
    if not argv or argv[0] not in _COMMANDS:
        print(
            "usage: python -m quinoa_tpu {inciter|walker|meshconv|rngtest} [options]",
            file=sys.stderr,
        )
        return 2
    return _COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
