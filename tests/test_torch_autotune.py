"""The port's tile ledger on the CPU (``repro_torch.kernels.autotune``),
test for test against the reference's ``tests/test_autotune.py``, adapted
where the port's rules differ: the CUDA kernels' shared-memory legality
instead of the VMEM rules, ``kb`` one of the kernel's column chunks, no
timing off the card, and a ledger that refuses an ``autotune`` entry keyed
to a device that is not a CUDA card."""
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch.backend.cuda_bsr import CudaBsrBackend
from repro_torch.kernels import autotune, bsr
from repro_torch.kernels.autotune import (
    DEFAULT_TILES, KB_WIDTHS, MAX_BK, MAX_BM, SMEM_BUDGET, TileConfig,
    autotune as run_autotune, column_chunk, fused_max_k, fused_working_set,
    legal_candidates, load_ledger, resolve_tiles, ring_stage_bytes,
    shape_bucket, spmm_working_set, update_ledger,
)
from repro_torch.kernels.bsr_spmm import bsr_spmm, resolve_kb

H100 = "nvidia_h100_80gb_hbm3"


@pytest.fixture
def ledger(tmp_path, monkeypatch):
    """Point the module at a throwaway ledger file and return its path."""
    path = tmp_path / "ledger.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_LEDGER", str(path))
    autotune._CACHE.clear()
    yield path
    autotune._CACHE.clear()


def _write(path, entries):
    path.write_text(json.dumps({"entries": entries}))
    autotune._CACHE.clear()


def _rand_sparse(rng, n, m, density=0.1):
    a = rng.random((n, m)).astype(np.float32)
    a[rng.random((n, m)) > density] = 0
    return a


@pytest.mark.parametrize("n,m,k", [
    (4096, 2048, 8), (3000, 2048, None), (129, None, None), (1, 1, 1),
    (20112, 7510, 5), (20112, 7510, 256), (7510, 20112, 33), (0, 0, 0),
    (143462, 12439, None), (2, 3, 128),
])
def test_shape_bucket_equals_the_reference(n, m, k):
    assert shape_bucket(n, m, k) == ref_autotune.shape_bucket(n, m, k)


def test_shape_bucket_pow2_and_wildcards():
    assert shape_bucket(4096, 2048, 8) == "n4096-m2048-k8"
    assert shape_bucket(3000, 2048, None) == "n4096-m2048-k*"
    assert shape_bucket(129) == "n256-m*-k*"
    assert shape_bucket(1, 1, 1) == "n1-m1-k1"


def test_device_kind_form():
    assert autotune.device_kind("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert autotune.device_kind() == "cpu"
    assert autotune.is_cuda_kind(H100)
    assert not autotune.is_cuda_kind("cpu")
    assert not autotune.is_cuda_kind("tpu_v5e")


def test_resolve_exact_bucket_hit(ledger):
    _write(ledger, {"testdev/n4096-m2048-k8": {"bm": 64, "bk": 32,
                                               "kb": 32}})
    tiles = resolve_tiles(4096, 2048, 8, device="testdev")
    assert (tiles.bm, tiles.bk, tiles.kb) == (64, 32, 32)
    # unmeasured fields inherit the defaults
    _write(ledger, {"testdev/n4096-m2048-k8": {"bm": 64}})
    tiles = resolve_tiles(4096, 2048, 8, device="testdev")
    assert (tiles.bk, tiles.kb) == (DEFAULT_TILES.bk, DEFAULT_TILES.kb)


def test_resolve_bucket_fallback_order(ledger):
    _write(ledger, {
        "testdev/n4096-m2048-k*": {"bm": 64},
        "testdev/n4096-m*-k*": {"bm": 32},
    })
    # no exact (n,m,k) entry: the k* bucket wins over the m*-k* bucket
    assert resolve_tiles(4096, 2048, 8, device="testdev").bm == 64
    # no (n,m,*) entry either: fall through to (n,*,*)
    assert resolve_tiles(4096, 999, 8, device="testdev").bm == 32


def test_resolve_missing_falls_back_to_defaults(ledger):
    assert resolve_tiles(64, 64, 4, device="testdev") == DEFAULT_TILES
    # absent file entirely
    assert load_ledger() == {"entries": {}}


def test_resolve_ignores_other_devices(ledger):
    _write(ledger, {f"{H100}/n4096-m2048-k8": {"bm": 64}})
    assert resolve_tiles(4096, 2048, 8, device="testdev") == DEFAULT_TILES
    assert resolve_tiles(4096, 2048, 8, device="cpu") == DEFAULT_TILES
    assert resolve_tiles(4096, 2048, 8, device=H100).bm == 64


def test_reference_fields_still_parse_and_a_foreign_kb_is_refused(ledger):
    _write(ledger, {"d/n64-m64-k*": {"bm": 64, "bk": 64, "kb": 8,
                                     "gram_bm": 512, "mask_bm": 256,
                                     "mask_bk": 256}})
    assert resolve_tiles(64, 64, None, device="d") == TileConfig(64, 64, 8)
    _write(ledger, {"d/n64-m64-k*": {"kb": 128}})  # the reference's kb
    with pytest.raises(ValueError, match="kb=128"):
        resolve_tiles(64, 64, None, device="d")


def test_ledger_cache_invalidated_on_update(ledger):
    assert resolve_tiles(4096, 2048, 8, device="d") == DEFAULT_TILES
    update_ledger("d/n4096-m2048-k8", {"bm": 64}, ledger)
    assert resolve_tiles(4096, 2048, 8, device="d").bm == 64


def test_ledger_is_read_once_a_process(ledger):
    """A ledger rewritten behind the module's back is not seen until the
    cache is emptied (``update_ledger`` empties it)."""
    _write(ledger, {"d/n64-m64-k*": {"bm": 64}})
    assert resolve_tiles(64, 64, None, device="d").bm == 64
    ledger.write_text(json.dumps({"entries": {"d/n64-m64-k*": {"bm": 32}}}))
    assert resolve_tiles(64, 64, None, device="d").bm == 64
    assert load_ledger()["entries"]["d/n64-m64-k*"] == {"bm": 64}
    autotune._CACHE.clear()
    assert resolve_tiles(64, 64, None, device="d").bm == 32


def test_ledger_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_LEDGER", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_LEDGER", "/nonexistent/ledger.json")
    path = autotune.ledger_path()
    assert path == Path(autotune.__file__).with_name("autotune_ledger.json")
    assert path != ref_autotune.ledger_path()


def test_update_ledger_refuses_non_gpu_timings(ledger):
    entry = {"bm": 64, "bk": 64, "kb": 8, "source": "autotune",
             "fused_us": 1.0}
    for kind in ("cpu", "tpu_v5e", "testdev"):
        with pytest.raises(ValueError, match="CUDA card"):
            update_ledger(f"{kind}/n64-m64-k8", entry, ledger)
    assert not ledger.exists()
    update_ledger(f"{H100}/n64-m64-k8", entry, ledger)
    # an entry no sweep timed may go anywhere
    update_ledger("cpu/n64-m64-k*", {"bm": 64, "source": "default-fallback"},
                  ledger)
    assert sorted(load_ledger(ledger)["entries"]) == [
        "cpu/n64-m64-k*", f"{H100}/n64-m64-k8"]


def test_committed_ledger_parses():
    """The committed ledger holds only entries measured on a CUDA card (or
    none), and every entry resolves to tiles the kernels take."""
    path = Path(autotune.__file__).with_name("autotune_ledger.json")
    data = load_ledger(path)
    if not path.exists():
        assert data == {"entries": {}}
        return
    assert data["entries"], "a committed ledger must hold entries"
    for key, entry in data["entries"].items():
        kind, bucket = key.split("/", 1)
        assert autotune.is_cuda_kind(kind), key
        assert entry["source"] == "autotune", key
        tiles = autotune._entry_to_tiles(entry, key)
        assert tiles.bm <= MAX_BM and tiles.bk <= MAX_BK
        assert tiles.kb in KB_WIDTHS
        assert bucket.startswith("n") and bucket.count("-") == 2


# ---------------------------------------------------------------------------
# The shared-memory legality filter
# ---------------------------------------------------------------------------

def test_legal_candidates_kernel_rules():
    cands = [(256, 128, 8),      # bm above MAX_BM
             (128, 132, 8),      # bk above MAX_BK
             (128, 6, 8),        # a tile row of 24 bytes: not 16-byte vectors
             (128, 128, 16),     # not a built column chunk
             (64, 36, 8),        # f32: 144 bytes a row, fine; bf16: 72, not
             (128, 128, 8)]
    assert legal_candidates(4096, 2048, 8, candidates=cands) == [
        (64, 36, 8), (128, 128, 8)]
    assert legal_candidates(4096, 2048, 8, itemsize=2, candidates=cands) == [
        (128, 128, 8)]


def test_legal_candidates_smem_budget():
    # at k = 128 the fused kernel fits 64 x 64 tiles in both orientations;
    # 128 x 64 only in A's (A^T's 64 x 128 tiles take k <= 112) and
    # 128 x 128 in neither: the fused backend would run it, so those go
    cands = [(128, 128, 32), (128, 64, 32), (64, 64, 8), (64, 64, 64)]
    assert legal_candidates(8192, 8192, 128, candidates=cands) == [
        (64, 64, 8), (64, 64, 64)]
    # at k = 256 nothing fuses (the Gram alone is 256 KB): the plain rule
    # alone applies
    assert legal_candidates(8192, 8192, 256, candidates=cands) == cands
    for bm, bk, kb in legal_candidates(20112, 7510, 128):
        for tiles in ((bm, bk), (bk, bm)):
            assert fused_working_set(*tiles, 128) <= SMEM_BUDGET
            assert spmm_working_set(*tiles, kb, 128) <= SMEM_BUDGET


def test_legal_candidates_oversized_blocks_dropped():
    # block dims more than 2x the operand are pure padding
    assert (128, 128, 8) not in legal_candidates(40, 2048, 8)
    assert (128, 128, 8) not in legal_candidates(4096, 60, 8)
    assert (64, 32, 8) in legal_candidates(40, 60, 8)


def test_legal_candidates_default_grid_all_legal():
    for k, itemsize in ((5, 4), (40, 4), (128, 4), (256, 4), (5, 2)):
        cands = legal_candidates(20112, 7510, k, itemsize)
        assert cands  # the defaults must be sweepable
        assert (DEFAULT_TILES.bm, DEFAULT_TILES.bk, DEFAULT_TILES.kb) in (
            cands) or fused_working_set(128, 128, k) > SMEM_BUDGET
        for bm, bk, kb in cands:
            assert bm <= MAX_BM and bk <= MAX_BK and kb in KB_WIDTHS
            assert (bk * itemsize) % 16 == 0
            assert spmm_working_set(bm, bk, kb, k, itemsize) <= SMEM_BUDGET
    # kb is moot at k <= 8: one chunk of 8 whatever it is
    assert {c[2] for c in legal_candidates(20112, 7510, 5)} == {8}
    assert {c[2] for c in legal_candidates(20112, 7510, 256)} == set(
        KB_WIDTHS)


def test_working_set_formulas():
    # one stage: the f32 tile and the (bk, w) f32 slab, quads of rows
    # 4 * (w | 1) floats apart, each rounded up to 128 bytes
    assert ring_stage_bytes(128, 128, 5) == 128 * 128 * 4 + 32 * 4 * 5 * 4
    assert ring_stage_bytes(128, 128, 8) == 128 * 128 * 4 + 32 * 4 * 9 * 4
    assert ring_stage_bytes(128, 128, 5, 2) == 128 * 128 * 2 + 32 * 4 * 5 * 4
    # 9 quads of 4 x 3 floats: 432 bytes, rounded up to 512
    assert ring_stage_bytes(64, 36, 3) == 64 * 36 * 4 + 512
    assert spmm_working_set(128, 128, 8, 5) == 256 + 2 * ring_stage_bytes(
        128, 128, 5)
    assert spmm_working_set(128, 128, 32, 256) == 256 + 2 * ring_stage_bytes(
        128, 128, 32)
    assert fused_working_set(128, 128, 4) == (
        256 + 128 + 2 * ring_stage_bytes(128, 128, 4))
    assert fused_working_set(128, 64, 128, 2) == (
        256 + 128 * 128 * 4 + 2 * ring_stage_bytes(128, 64, 128, 2))
    assert [column_chunk(k, kb) for k, kb in
            ((5, 64), (8, 32), (9, 8), (9, 32), (256, 64))] == [
        8, 8, 8, 32, 64]


@pytest.mark.parametrize("bm,bk,itemsize,k_max", [
    (128, 128, 4, 75), (128, 64, 4, 149), (128, 32, 4, 193),
    (64, 64, 4, 168), (128, 128, 2, 112), (128, 64, 2, 168),
])
def test_fused_max_k_is_the_backends_gate(bm, bk, itemsize, k_max):
    assert fused_max_k(bm, bk, itemsize) == k_max
    assert fused_working_set(bm, bk, k_max, itemsize) <= SMEM_BUDGET
    assert fused_working_set(bm, bk, k_max + 1, itemsize) > SMEM_BUDGET
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    be = CudaBsrBackend()
    a = types.SimpleNamespace(bm=bm, bk=bk)
    assert be._fusable(a, torch.zeros((1, k_max), dtype=dtype))
    assert not be._fusable(a, torch.zeros((1, k_max + 1), dtype=dtype))


# ---------------------------------------------------------------------------
# The sweep: nothing is timed off the card
# ---------------------------------------------------------------------------

def test_autotune_off_card_returns_default_fallback(monkeypatch):
    def no_timing(*a, **kw):
        raise AssertionError("autotune timed something off the card")

    monkeypatch.setattr(autotune, "_timed_us", no_timing)
    for kw in ({}, {"device": "cpu"}):
        if torch.cuda.is_available() and not kw:
            continue
        entry = run_autotune(256, 256, 8, **kw)
        assert entry["source"] == "default-fallback"
        assert (entry["bm"], entry["bk"], entry["kb"]) == (
            DEFAULT_TILES.bm, DEFAULT_TILES.bk, DEFAULT_TILES.kb)
        assert "fused_us" not in entry  # nothing was timed


def test_autotune_main_off_card_writes_nothing(ledger, capsys):
    if torch.cuda.is_available():
        pytest.skip("sweeps for real on a card")
    assert autotune.main(["--n", "64", "--m", "64", "--k", "4"]) == 1
    assert not ledger.exists()
    assert "default-fallback" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Call sites resolve through the ledger
# ---------------------------------------------------------------------------

def test_bsr_spmm_kb_none_resolves_through_the_ledger(ledger):
    rng = np.random.default_rng(0)
    a = _rand_sparse(rng, 128, 256, density=0.3)
    b = bsr.bsr_from_dense(a, bm=64, bk=64)
    u = torch.from_numpy(rng.standard_normal((256, 40)).astype(np.float32))
    assert resolve_kb(b, u, None) == DEFAULT_TILES.kb
    _write(ledger, {f"cpu/{shape_bucket(128, 256, 40)}": {"kb": 32}})
    assert resolve_kb(b, u, None) == 32
    assert resolve_kb(b, u, 64) == 64
    with pytest.raises(ValueError, match="column chunks"):
        resolve_kb(b, u, 16)
    np.testing.assert_allclose(bsr_spmm(b, u, kb=None).numpy(),
                               a @ u.numpy(), rtol=1e-5, atol=1e-5)


def test_cuda_bsr_prepare_resolves_through_the_ledger(ledger):
    rng = np.random.default_rng(1)
    a = _rand_sparse(rng, 200, 150)
    op = CudaBsrBackend().prepare(a, device="cpu")
    assert (op.bsr.bm, op.bsr.bk) == (DEFAULT_TILES.bm, DEFAULT_TILES.bk)
    _write(ledger, {f"cpu/{shape_bucket(200, 150, None)}": {"bm": 64,
                                                            "bk": 32},
                    f"cpu/{shape_bucket(200, 150, 40)}": {"kb": 64}})
    be = CudaBsrBackend()
    op = be.prepare(a, device="cpu")
    assert (op.bsr.bm, op.bsr.bk) == (64, 32)
    assert (op.bsr_t.bm, op.bsr_t.bk) == (32, 64)
    # construction-time pins on top of the ledger
    pinned = CudaBsrBackend(bm=32).prepare(a, device="cpu")
    assert (pinned.bsr.bm, pinned.bsr.bk) == (32, 32)
    # the column chunk of both orientations, per call
    assert be._kb(op, torch.zeros((150, 40))) == 64
    assert be._kb(op, torch.zeros((200, 5))) == DEFAULT_TILES.kb


def test_mesh_ingest_takes_the_resolved_tiles(ledger):
    from repro_torch.backend.sharded import SHARD_FORMATS
    from repro_torch.core.distributed import _coo_of
    from repro_torch.launch.mesh import NMFMesh

    rng = np.random.default_rng(2)
    a = _rand_sparse(rng, 400, 300)
    coo = _coo_of(a)
    # the ledger is keyed by a block's shape, (n / rows, m / cols)
    _write(ledger, {f"cpu/{shape_bucket(200, 150, None)}": {"bm": 32,
                                                            "bk": 64}})
    fmt = SHARD_FORMATS["cuda-bsr"]
    for rank in range(4):
        mesh = NMFMesh(rows=2, cols=2, rank=rank, device=torch.device("cpu"))
        block = fmt.block(coo, mesh, torch.device("cpu"))
        assert (block.op.bsr.bm, block.op.bsr.bk) == (32, 64)
        assert (block.op.bsr_t.bm, block.op.bsr_t.bk) == (64, 32)
    # no entry for a 4x1 block's shape: the defaults
    mesh = NMFMesh(rows=4, cols=1, rank=0, device=torch.device("cpu"))
    block = fmt.block(coo, mesh, torch.device("cpu"))
    assert (block.op.bsr.bm, block.op.bsr.bk) == (DEFAULT_TILES.bm,
                                                  DEFAULT_TILES.bk)
