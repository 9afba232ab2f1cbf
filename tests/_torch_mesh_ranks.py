"""Rank bodies for the mesh tests (``test_torch_mesh.py``,
``test_torch_sharded.py``, ``test_torch_sharded_stream.py``).

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
