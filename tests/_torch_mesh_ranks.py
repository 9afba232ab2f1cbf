"""Rank bodies for the mesh tests (``test_torch_mesh.py``,
``test_torch_sharded.py``, ``test_torch_sharded_stream.py``,
``test_torch_moe_ep.py``, ``test_torch_sharding.py``,
``test_torch_sharding_families.py``), and the train launcher started
under ``torch.distributed.run`` for the sharding tests.

Each function runs in a process started by
:func:`repro_torch.launch.mesh.spawn_mesh` (one rank of a gloo group on
the CPU) and returns plain numpy values.  The module imports only numpy,
torch and the port, so a rank starts without the reference package.
"""
import numpy as np
import torch


def _cfg(kw):
    from repro_torch.nmf import NMFConfig, Sparsity

    kw = dict(kw)
    kw["sparsity"] = Sparsity(**kw.get("sparsity", {}))
    return NMFConfig(**kw)


def _input(a_dense, kind):
    import scipy.sparse as sp

    from repro_torch.sparse import from_dense

    if kind == "scipy":
        return sp.csr_matrix(a_dense)
    if kind == "spcsr":
        return from_dense(a_dense)
    if kind == "bsr":
        from repro_torch.kernels.bsr import bsr_operand

        return bsr_operand(a_dense)
    return a_dense


def _result(model):
    from repro_torch.launch.mesh import collective_counts

    r = model.result_
    out = dict(u=model.u_.cpu().numpy(), v=model.v_.cpu().numpy(),
               err=r.error.cpu().numpy(), res=r.residual.cpu().numpy(),
               max_nnz=int(r.max_nnz), n_iter=int(r.n_iter),
               converged=bool(r.converged), health=int(r.health),
               collectives=collective_counts())
    if r.nnz_u is not None:
        out.update(nnz_u=r.nnz_u.cpu().numpy(), nnz_v=r.nnz_v.cpu().numpy())
    if model._av_acc is not None:
        out.update(av=model._av_acc.cpu().numpy(),
                   gv=model._gv_acc.cpu().numpy())
    return out


def fit_cases(rank, data_path, cases, device="cpu"):
    """``{name: result}`` of ``EnforcedNMF(config).fit(input, u0)`` on
    ``device`` for each ``(name, config kwargs, input kind)``, with the
    fit's kernel launches (counted on the card only)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import reset_collective_counts
    from repro_torch.nmf import EnforcedNMF

    d = np.load(data_path)
    out = {}
    for name, kw, kind in cases:
        reset_collective_counts()
        _build.reset_launch_counts()
        model = EnforcedNMF(_cfg(kw), device=device).fit(
            _input(d["a"], kind), u0=d["u0"])
        out[name] = dict(_result(model), launches=_build.launch_counts())
    return out


def stream_cases(rank, data_path, cases):
    """``{name: result}`` of a ``partial_fit`` sequence over column ranges
    (``chunks``), or of a streamed ``fit`` (``chunks`` None)."""
    from repro_torch.nmf import EnforcedNMF

    d = np.load(data_path)
    out = {}
    for name, kw, chunks, kind in cases:
        model = EnforcedNMF(_cfg(kw), device="cpu")
        model.u_ = torch.from_numpy(d["u0"])
        model.n_features_ = d["u0"].shape[0]
        if chunks is None:
            model.fit(_input(d["a"], kind), u0=d["u0"])
            out[name] = _result(model)
            continue
        for lo, hi in chunks:
            model.partial_fit(_input(d["a"][:, lo:hi], kind))
        out[name] = dict(u=model.u_.numpy(), v=model.v_.numpy(),
                         av=model._av_acc.numpy(),
                         gv=model._gv_acc.numpy(),
                         n_docs=model.n_docs_seen_)
    return out


def kill_then_report(rank, data_path, kw, key):
    """A checkpointed fit killed (by an exception) at the commit of
    snapshot ``key``; returns what was written."""
    from repro_torch.nmf import EnforcedNMF
    from repro_torch.robustness import faults

    class Killed(Exception):
        pass

    d = np.load(data_path)
    try:
        with faults.inject("kill", key=key, exc=Killed):
            EnforcedNMF(_cfg(kw), device="cpu").fit(d["a"], u0=d["u0"])
    except Killed:
        return "killed"
    return "not killed"


def resume_and_plain(rank, data_path, kw, plain_kw):
    """The resumed fit's result and the uninterrupted fit's."""
    from repro_torch.nmf import EnforcedNMF

    d = np.load(data_path)
    resumed = EnforcedNMF(_cfg(kw), device="cpu").fit(d["a"], u0=d["u0"],
                                                      resume=True)
    plain = EnforcedNMF(_cfg(plain_kw), device="cpu").fit(d["a"],
                                                          u0=d["u0"])
    return dict(resumed=_result(resumed), plain=_result(plain))


def topk_blocks(rank, x, t, shape):
    """``tau`` and the kept mask of ``DistTopK`` over ``"data"`` on this
    rank's rows of ``x`` (the factor U of a ``shape`` mesh)."""
    from repro_torch.core.topk import DistTopK, dist_topk_threshold
    from repro_torch.launch.mesh import make_nmf_mesh

    mesh = make_nmf_mesh(*shape, device="cpu")
    xb = torch.from_numpy(x)[mesh.row_block(x.shape[0])]
    tau = dist_topk_threshold(xb, t, mesh, ("data",))
    kept = DistTopK(t, mesh, ("data",))(xb)
    return dict(tau=float(tau), kept=(kept != 0).numpy(), i=mesh.i,
                j=mesh.j)


def mesh_of(rank, shape):
    """This rank's place on the grid and a reduction over each axis."""
    from repro_torch.launch.mesh import make_nmf_mesh

    mesh = make_nmf_mesh(*shape, device="cpu")
    x = torch.tensor([float(rank)])
    return dict(i=mesh.i, j=mesh.j,
                data=float(mesh.all_reduce(x, ("data",))),
                model=float(mesh.all_reduce(x, ("model",))),
                both=float(mesh.all_reduce(x, ("data", "model"))),
                max=float(mesh.all_reduce(x, ("data",), op="max")))


def mesh_made_twice(rank, shape):
    """The collectives of a first and of a second ``make_nmf_mesh`` of one
    grid, and whether the second returned the first's mesh."""
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )

    reset_collective_counts()
    first = make_nmf_mesh(*shape, device="cpu")
    made = collective_counts()["all_reduce"]
    reset_collective_counts()
    again = make_nmf_mesh(*shape, device="cpu")
    return dict(made=made, again=collective_counts()["all_reduce"],
                same=again is first)


def slow_packer_stream(rank, data_path, kw, slow_rank, delay):
    """A streamed fit with prefetch on, as it is and with rank
    ``slow_rank``'s chunk packer (the prefetch worker's work) held back
    ``delay`` seconds before every chunk, so that rank's worker runs far
    behind its main thread's collectives."""
    import time

    from repro_torch.nmf import EnforcedNMF

    d = np.load(data_path)
    out = {"plain": _result(EnforcedNMF(_cfg(kw), device="cpu").fit(
        d["a"], u0=d["u0"]))}
    pack = EnforcedNMF._pack_mesh_chunk

    def held_back(*args, **kwargs):
        time.sleep(delay)
        return pack(*args, **kwargs)

    # on the class: the streaming solver packs through an estimator of its
    # own
    if rank == slow_rank:
        EnforcedNMF._pack_mesh_chunk = held_back
    try:
        out["slowed"] = _result(EnforcedNMF(_cfg(kw), device="cpu").fit(
            d["a"], u0=d["u0"]))
    finally:
        EnforcedNMF._pack_mesh_chunk = pack
    return out


def mesh_shape_per_rank(rank, shapes):
    """``make_nmf_mesh`` with this rank's entry of ``shapes``."""
    from repro_torch.launch.mesh import make_nmf_mesh

    make_nmf_mesh(*shapes[rank], device="cpu")
    return "made"


def fail_on(rank, bad_rank):
    if rank == bad_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return rank


def block_fingerprints(rank, a, shape):
    """This rank's fingerprint of its own ``DistBSR`` and ``DistCSR``
    block of ``a`` (agreed over the grid by an ``all_reduce``), and of the
    whole input."""
    from repro_torch.backend.sharded import make_sharded_als
    from repro_torch.launch.mesh import make_nmf_mesh
    from repro_torch.robustness.snapshot import data_fingerprint

    mesh = make_nmf_mesh(*shape, device="cpu")
    out = {"whole": data_fingerprint(torch.from_numpy(a), mesh)}
    for inner in ("cuda-bsr", "torch-csr"):
        block = make_sharded_als(mesh, inner=inner).distribute(a)
        out[inner] = data_fingerprint(block, mesh)
    return out


def compressed_grads(rank, arrays, density, steps):
    """``steps`` calls of ``make_compressed_grad_fn`` on a 4x1 grid (data
    axis of 4) for the least-squares loss of ``tests/test_distributed.py``,
    the error slot carried from call to call; each call's loss, averaged
    gradient and slots in and out, and the collectives counted."""
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )
    from repro_torch.training import init_error_state, make_compressed_grad_fn

    mesh = make_nmf_mesh(4, 1, device="cpu")

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2)

    params = {"w": torch.from_numpy(arrays["w"])}
    batch = {"x": torch.from_numpy(arrays["x"]),
             "y": torch.from_numpy(arrays["y"])}
    grad_fn = make_compressed_grad_fn(loss_fn, mesh, ("data",), density)
    err = init_error_state(params, 4)
    reset_collective_counts()
    out = []
    for _ in range(steps):
        loss, g, new = grad_fn(params, batch, err)
        out.append(dict(loss=float(loss), g=g["w"].numpy(),
                        err_in=err["w"].numpy(), err=new["w"].numpy()))
        err = new
    return out, collective_counts()


#: every axis set of a grid of several pods
AXIS_SETS = (("pod",), ("data",), ("model",), ("pod", "data"),
             ("pod", "model"), ("data", "model"), ("pod", "data", "model"))


def _exchange(mesh, rank):
    """``all_to_all`` over each axis set of more than one rank: part g of
    ``1000 * rank + arange(2 * n)`` (two rows a part) goes to the g-th rank
    of the set."""
    out = {}
    for axes in AXIS_SETS:
        n = mesh.axis_size(axes)
        if n > 1:
            x = 1000.0 * rank + torch.arange(2.0 * n)
            out[axes] = mesh.all_to_all(x, axes).numpy()
    return out


def multipod(rank, arrays, density):
    """Eight ranks as a 2x2x2 (pod, data, model) grid, and the same ranks
    as a 4x2 grid: this rank's coordinates, a sum of the rank over every
    axis set and an ``all_to_all`` over each; ``dist_topk_threshold`` and
    ``DistTopK(40, ("pod", "data"))`` of the rows of ``x``; the reference
    test's 10-iteration fit (``make_sharded_als(mesh, ("pod", "data"),
    "model", ...)`` on ``torch-csr``) on 2x2x2 and on 4x2 with its
    collectives; compressed gradients over ``("pod", "data")``."""
    from repro_torch.backend.sharded import make_sharded_als
    from repro_torch.core.topk import DistTopK, dist_topk_threshold
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )
    from repro_torch.training import init_error_state, make_compressed_grad_fn

    mesh = make_nmf_mesh(2, 2, device="cpu", pods=2)
    one = torch.tensor([float(rank)])
    out = dict(coords=(mesh.p, mesh.i, mesh.j), shape=mesh.shape,
               row_index=mesh.index(("pod", "data")),
               sums={axes: float(mesh.all_reduce(one, axes))
                     for axes in AXIS_SETS},
               exchange=_exchange(mesh, rank))
    xb = torch.from_numpy(arrays["x"])[mesh.row_block(arrays["x"].shape[0])]
    out["tau"] = float(dist_topk_threshold(xb, 40, mesh, ("pod", "data")))
    out["kept"] = (DistTopK(40, mesh, ("pod", "data"))(xb) != 0).numpy()

    def fit(m, rows_axes):
        engine = make_sharded_als(
            m, rows_axes, "model",
            sparsify_u=DistTopK(40, m, rows_axes),
            sparsify_v=DistTopK(100, m, ("model",)), inner="torch-csr")
        dist = engine.distribute(arrays["a"])
        u0 = torch.from_numpy(arrays["u0"])[m.row_block(
            arrays["u0"].shape[0])]
        reset_collective_counts()
        r = engine(dist, u0, 10)
        return dict(err=r.error.numpy(), res=r.residual.numpy(),
                    u=r.u.numpy(), v=r.v.numpy(),
                    collectives=collective_counts())

    out["fit_2x2x2"] = fit(mesh, ("pod", "data"))
    out["fit_4x2"] = fit(make_nmf_mesh(4, 2, device="cpu"), ("data",))

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    params = {"w": torch.from_numpy(arrays["w"])}
    batch = {"x": torch.from_numpy(arrays["bx"]),
             "y": torch.from_numpy(arrays["by"])}
    grad_fn = make_compressed_grad_fn(loss_fn, mesh, ("pod", "data"),
                                      density)
    loss, g, err = grad_fn(params, batch, init_error_state(params, 4))
    out["compressed"] = dict(loss=float(loss), g=g["w"].numpy(),
                             err=err["w"].numpy())
    return out


def moe_ep(rank, data_path, grids):
    """``moe_ffn_ep`` of the smoke olmoe config on each ``(pods, rows,
    cols)`` grid of these ranks, for the inputs ``x`` and ``x_odd`` of the
    file: this rank's output, its block and the collectives counted."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )
    from repro_torch.models.moe import ep_block, moe_ffn_ep

    d = np.load(data_path)
    cfg = smoke_config(ARCHS["olmoe-1b-7b"])
    p = {n: torch.from_numpy(d[n]) for n in ("router", "w_gate", "w_up",
                                              "w_down")}
    out = {}
    for pods, rows, cols in grids:
        mesh = make_nmf_mesh(rows, cols, device="cpu", pods=pods)
        for name in ("x", "x_odd"):
            x = torch.from_numpy(d[name])
            reset_collective_counts()
            y = moe_ffn_ep(p, x, cfg, mesh)
            bsl, ssl = ep_block(mesh, x.shape[0], x.shape[1])
            out[(pods, rows, cols, name)] = dict(
                y=y.numpy(), block=(bsl.start, bsl.stop, ssl.start,
                                    ssl.stop),
                counts=collective_counts())
        out[(pods, rows, cols, "exchange")] = _exchange(mesh, rank)
    return out


def sharded_steps(rank, grids, cases_path):
    """One f32 sharded train step on each ``(data, model)`` grid of these
    ranks for each ``(key, arch, whole parameters, batch)`` (and a MoE
    capacity factor, 1.25 when left out) of the pickled list at
    ``cases_path`` (a file: arguments this large would start the ranks one
    after another), keyed ``(grid, key)``: the loss (every rank), this
    rank's bytes of parameters, mu and nu, the blocks that ran split over
    "model", and on rank 0 the gradients gathered whole and the
    collectives counted."""
    import pickle

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.mesh import (
        collective_counts, make_local_mesh, reset_collective_counts,
    )
    from repro_torch.models import api
    from repro_torch.training import AdamW, sharding

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for grid in grids:
        mesh = make_local_mesh(*grid, device="cpu")
        for key, arch, whole, batch, *cf in cases:
            cfg = smoke_config(ARCHS[arch])
            model = api.init_params(cfg, 0, device="cpu")
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(torch.from_numpy(whole[name]))
            shards = sharding.shard_model(model, mesh)
            got = {}

            class Capture(AdamW):
                def update(self, grads, state, params):
                    got.update(grads)
                    return params, state

            opt = Capture()
            state = opt.init(model)
            reset_collective_counts()
            step = sharding.make_train_step(cfg, opt, shards,
                                            compute_dtype=torch.float32,
                                            capacity_factor=(cf or [1.25])[0])
            _, _, loss = step(model, state, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
            counts = collective_counts()
            grads = sharding.gather_named(shards, got)
            rec = out[(grid, key)] = dict(
                loss=float(loss), bytes=sharding.state_bytes(model, state),
                plan=(shards.tp_attn, shards.tp_mlp, shards.tp_vocab),
                split=(shards.tp_ssm, shards.ep))
            if rank == 0:
                rec.update(grads={n: g.numpy() for n, g in grads.items()},
                           counts=counts)
    return out


def sharded_inits(rank, grids, archs):
    """On each ``(data, model)`` grid of these ranks, for each arch at its
    smoke config: whether ``sharding.init_sharded``'s blocks are bitwise
    ``shard_model(api.init_params(cfg, 0))``'s (the names that differ),
    and what ``gather_state`` returns on this rank: None, or (rank 0) the
    names whose whole leaves differ from the whole model's, and the host
    device of every leaf."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.training import AdamW, sharding

    out = {}
    for grid in grids:
        mesh = make_local_mesh(*grid, device="cpu")
        for arch in archs:
            cfg = smoke_config(ARCHS[arch])
            want = api.init_params(cfg, 0, device="cpu")
            whole = {n: p.detach().clone()
                     for n, p in want.named_parameters()}
            sharding.shard_model(want, mesh)
            got, shards = sharding.init_sharded(cfg, mesh, 0, "cpu")
            blocks = dict(want.named_parameters())
            differ = sorted(n for n, p in got.named_parameters()
                            if not torch.equal(p, blocks[n])
                            or p.dtype != blocks[n].dtype)
            state = AdamW().init(got)
            tree = sharding.gather_state(got, state, shards)
            rec = dict(differ=differ, names=sorted(blocks),
                       state=None if tree is None else "kept")
            if tree is not None:
                params, st = tree
                rec["whole_differ"] = sorted(
                    n for n, t in whole.items()
                    if not torch.equal(params[n], t))
                rec["mu_shapes_ok"] = all(
                    tuple(st.mu[n].shape) == tuple(t.shape)
                    for n, t in whole.items())
                rec["devices"] = sorted({str(t.device) for t in
                                         (*params.values(), *st.mu.values(),
                                          *st.nu.values())})
            out[(grid, arch)] = rec
    return out


def exchange_grads(rank, data_path):
    """``moe_ffn_ep`` of the smoke olmoe config on the 2x2 grid of these
    ranks with ``x`` and the weights of the file requiring gradients: the
    gradients of ``sum(y * u)`` (``u`` the file's cotangent, cut to this
    rank's block) summed over the ranks, and the exchanges counted; and
    the weights' gradients again with ``x`` a constant
    (``weights_only``)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )
    from repro_torch.models.moe import ep_block, moe_ffn_ep

    d = np.load(data_path)
    cfg = smoke_config(ARCHS["olmoe-1b-7b"])
    mesh = make_nmf_mesh(2, 2, device="cpu")
    leaves = {n: torch.from_numpy(d[n]).requires_grad_()
              for n in ("router", "w_gate", "w_up", "w_down", "x")}
    x = leaves.pop("x")
    bsl, ssl = ep_block(mesh, x.shape[0], x.shape[1])
    reset_collective_counts()
    y = moe_ffn_ep(leaves, x, cfg, mesh)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(d["u"])[bsl, ssl]).sum(),
        [x, *leaves.values()])
    counts = collective_counts()
    summed = [mesh.all_reduce(g, ("data", "model")) for g in grads]
    y = moe_ffn_ep(leaves, x.detach(), cfg, mesh)
    weights = torch.autograd.grad(
        (y * torch.from_numpy(d["u"])[bsl, ssl]).sum(), list(leaves.values()))
    return dict(counts=counts, grads=dict(zip(["x", *leaves],
                                              (g.numpy() for g in summed))),
                weights_only={n: mesh.all_reduce(g, ("data", "model")).numpy()
                              for n, g in zip(leaves, weights)})


def family_runs(rank, grids, cases_path, init_archs, exchange_path):
    """The sharding tests' one world: :func:`sharded_steps` of the pickled
    cases and :func:`sharded_inits` of ``init_archs`` on each grid, and
    :func:`exchange_grads`."""
    return dict(steps=sharded_steps(rank, grids, cases_path),
                inits=sharded_inits(rank, grids, init_archs),
                exchange=exchange_grads(rank, exchange_path))


def launch_train(src, arch, ckpt, steps, grid=(2, 2), extra=()):
    """``python -m torch.distributed.run`` of the train launcher at
    ``arch``'s smoke config on ``grid`` (one process on 1x1), batch 4 x 32
    on the CPU, checkpoints every 3 steps in ``ckpt``, deterministic,
    started with ``src`` on its path; returns its command, environment and
    process."""
    import os
    import subprocess
    import sys

    data, model = grid
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           arch, "--smoke", "--device", "cpu", "--batch", "4",
           "--seq", "32", "--steps", str(steps), "--ckpt-dir", str(ckpt),
           "--ckpt-every", "3", "--deterministic", "--data", str(data),
           "--model", str(model), *extra]
    if data * model > 1:
        cmd[1:3] = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(data * model), "-m",
                    "repro_torch.launch.train"]
        cmd += ["--dist-backend", "gloo"]
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    return cmd, env, subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)


def train_done(run):
    """A :func:`launch_train` run's output once it exits 0.  A run whose
    gloo group failed to connect (``connectFullMesh``: the transport's
    flake on one host, in ``init_process_group``, before any step) is
    started again, up to twice, as ``spawn_mesh`` starts such a grid
    again."""
    import subprocess

    cmd, env, proc = run
    for _ in range(3):
        out, err = proc.communicate(timeout=300)
        if proc.returncode == 0 or "connectFullMesh failed" not in err:
            break
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    assert proc.returncode == 0, err[-3000:]
    return out


def serving_runs(rank, grids, cases_path):
    """The sharded serving steps (``serving/sharding.py``) in f32 on each
    ``(pods, data, model)`` grid of these ranks for each pickled case
    ``(arch, whole parameters, prefill batch, whole decode state, token
    column, positions, moe capacity factor)``, keyed ``(grid, arch)``:
    this rank's prefill block, and for each position (from the whole
    state, sharded afresh) its logits block, its state blocks after the
    step, its state bytes and the collectives; the zero state of
    ``init_sharded_cache`` against the same state cut; the placement
    plan."""
    import pickle

    from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
    from repro_torch.convert import cache_from_reference
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )
    from repro_torch.models import api
    from repro_torch.serving import sharding as serving
    from repro_torch.training import sharding

    def leaves(tree):
        if isinstance(tree, dict):
            return {f"{k}/{p}" if p else str(k): t
                    for k, v in tree.items() for p, t in leaves(v).items()}
        if isinstance(tree, list):
            return {f"{i}/{p}" if p else str(i): t
                    for i, v in enumerate(tree) for p, t in leaves(v).items()}
        return {} if tree is None else {"": tree}

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for pods, rows, cols in grids:
        mesh = make_nmf_mesh(rows, cols, device="cpu", pods=pods)
        for arch, whole, batch, state, token, positions, cf in cases:
            cfg = smoke_config(ARCHS[arch])
            model = api.init_params(cfg, 0, device="cpu")
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(torch.from_numpy(whole[name]))
            shards = sharding.shard_model(model, mesh)
            batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
            prefill = serving.make_prefill_step(
                cfg, shards, torch.float32, capacity_factor=cf)(model,
                                                                batch_t)
            rec = dict(prefill=prefill.numpy(), decode={},
                       plan=(shards.tp_attn, shards.tp_vocab, shards.tp_ssm))
            b = token.shape[0]
            t = (state["ck"].shape[2] if cfg.family == "encdec" else
                 1 if cfg.family == "ssm" else state["k"].shape[2])
            shape = ShapeSpec("serving", t, b, "decode")
            whole_state = cache_from_reference(state, cfg, "cpu")
            step = serving.make_decode_step(cfg, shards, torch.float32,
                                            capacity_factor=cf)
            for pos in positions:
                cache = serving.shard_cache(whole_state, cfg, shape, mesh)
                reset_collective_counts()
                logits, back = step(model, cache, torch.from_numpy(token),
                                    pos)
                rec["decode"][pos] = dict(
                    logits=logits.numpy(), same=back is cache,
                    blocks={k: v.numpy()
                            for k, v in leaves(cache.blocks).items()},
                    bytes=serving.cache_bytes(cache),
                    counts=collective_counts())
            zero = serving.init_sharded_cache(cfg, shape, mesh, "cpu",
                                              dtype=torch.float32)
            want = serving.shard_cache(api.init_decode_cache(
                cfg, shape, dtype=torch.float32, device="cpu"), cfg, shape,
                mesh)
            got_z, want_z = leaves(zero.blocks), leaves(want.blocks)
            rec["zero_ok"] = got_z.keys() == want_z.keys() and all(
                torch.equal(got_z[k], want_z[k]) for k in got_z)
            out[((pods, rows, cols), arch)] = rec
    return out


def serving_counts(rank, cells):
    """Each ``(arch, seq, batch, kind)`` cell's sharded serving step of the
    smoke config on the 2x2 grid of these ranks, in bf16 (the steps'
    default) from seed 0: the collectives, the flash wrapper's calls and
    this rank's state bytes (a decode at ``seq - 1``, as the dry-run
    steps)."""
    from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )
    from repro_torch.models import api
    from repro_torch.serving import sharding as serving
    from repro_torch.training import sharding

    mesh = make_nmf_mesh(2, 2, device="cpu")
    calls = {"flash_attention": 0}
    plain = serving.flash_attention

    def counted(*args, **kwargs):
        calls["flash_attention"] += 1
        return plain(*args, **kwargs)

    serving.flash_attention = counted
    from repro_torch.models import common
    common_plain = common.flash_attention
    common.flash_attention = counted
    out = {}
    try:
        for arch, seq, b, kind in cells:
            cfg = smoke_config(ARCHS[arch])
            shape = ShapeSpec("cell", seq, b, kind)
            model, shards = sharding.init_sharded(cfg, mesh, 0, "cpu")
            calls["flash_attention"] = 0
            if kind == "prefill":
                batch = api.make_batch(cfg, shape, 0, device="cpu")
                step = serving.make_prefill_step(cfg, shards)
                reset_collective_counts()
                step(model, batch)
                state = 0
            else:
                cache = serving.init_sharded_cache(cfg, shape, mesh, "cpu",
                                                   seed=1)
                token = torch.zeros((b,), dtype=torch.int32)
                step = serving.make_decode_step(cfg, shards)
                reset_collective_counts()
                step(model, cache, token, seq - 1)
                state = serving.cache_bytes(cache)
            out[(arch, kind)] = dict(counts=collective_counts(),
                                     launches=dict(calls), state=state)
    finally:
        serving.flash_attention = plain
        common.flash_attention = common_plain
    return out
