"""Checkpoint/resume in the port (``workflow/checkpoint.py``
``StepCheckpointer`` and the chunked loop of ``ops/als.py _train_packed``)
on the CPU: the checkpointer's cadence, retention and atomic write, and the
reference's three cases (``tests/test_checkpoint.py``: resume equals an
uninterrupted run, changed data starts fresh, a finished run short-circuits)
through ``train_als``, ``train_from_wire``, ``train_als_streaming``, the
recommendation template's ``ALSAlgorithm.train`` and a resident scatter
round, whose data identity is its cache entry's fingerprint and cursor.

Tolerances: none. The loop sums in a fixed order and a checkpoint holds the
float32 factors exactly, so a resumed run equals an uninterrupted one bit
for bit, as a fresh run equals another.
"""

import logging

import numpy as np
import pytest

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage.columnar import ColumnarStream
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    Preparator,
    StreamingTrainingData,
    TrainingData,
)
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import normal_eq as k1
from predictionio_tpu_torch.ops import streaming as port_streaming
from predictionio_tpu_torch.workflow.checkpoint import StepCheckpointer
from tests.test_torch_delta import scatterable_delta, seeded_store

N_USERS, N_ITEMS, NNZ = 30, 20, 300
CFG = dict(rank=4, reg=0.05, seed=3, segment_length=16, chunk_slots=1024)


def synthetic(seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    r = rng.uniform(1, 5, NNZ).astype(np.float32)
    return u, i, r


def config(iterations, **kw):
    return port_als.ALSConfig(**dict(CFG, iterations=iterations, **kw))


def same_bits(a, b):
    return all(
        np.array_equal(x.view(np.uint32), y.view(np.uint32))
        for x, y in ((a.user_factors, b.user_factors), (a.item_factors, b.item_factors))
    )


def train(data, cfg, ckdir=None, every=1, timings=None):
    u, i, r = data
    return port_als.train_als(u, i, r, N_USERS, N_ITEMS, cfg, device="cpu",
                              checkpoint_dir=ckdir, checkpoint_every=every, timings=timings)


class TestStepCheckpointer:
    def test_disabled_when_no_dir(self):
        ckpt = StepCheckpointer(None)
        assert not ckpt.enabled and ckpt.latest_step() is None
        assert ckpt.restore_latest() is None
        assert not ckpt.maybe_save(1, {"x": 1})

    def test_save_restore_cadence(self, tmp_path):
        ckpt = StepCheckpointer(str(tmp_path / "ck"), every=2, max_to_keep=2)
        assert not ckpt.maybe_save(1, {"step": 1})  # off-cadence
        assert ckpt.maybe_save(2, {"step": 2, "a": np.arange(3)})
        assert ckpt.maybe_save(3, {"step": 3}, force=True)
        ckpt.close()
        ckpt2 = StepCheckpointer(str(tmp_path / "ck"), every=2)
        assert ckpt2.latest_step() == 3
        assert int(ckpt2.restore_latest()["step"]) == 3

    def test_keeps_the_newest_steps(self, tmp_path):
        ckpt = StepCheckpointer(str(tmp_path), every=1, max_to_keep=2)
        for step in (1, 2, 3, 10):
            ckpt.maybe_save(step, {"step": step, "a": np.full(4, step, np.float32)})
        assert sorted(p.name for p in tmp_path.iterdir()) == ["step_10.npz", "step_3.npz"]
        state = ckpt.restore_latest()
        assert int(state["step"]) == 10 and state["a"].tolist() == [10.0] * 4

    def test_a_failed_write_leaves_the_last_whole_step(self, tmp_path, monkeypatch):
        ckpt = StepCheckpointer(str(tmp_path), every=1)
        ckpt.maybe_save(1, {"step": 1})

        def broken(f, **arrays):
            f.write(b"PK\x03\x04 half a file")
            raise OSError("disk full")

        monkeypatch.setattr(np, "savez", broken)
        with pytest.raises(OSError):
            ckpt.maybe_save(2, {"step": 2})
        monkeypatch.undo()
        assert ckpt.latest_step() == 1
        assert int(StepCheckpointer(str(tmp_path)).restore_latest()["step"]) == 1

    def test_the_docstrings_nested_state_restores_equal(self, tmp_path):
        rng = np.random.default_rng(4)
        arrays = {"user_factors": rng.normal(size=(5, 3)).astype(np.float32),
                  "item_factors": rng.normal(size=(7, 3)).astype(np.float32)}
        ckpt = StepCheckpointer(str(tmp_path), every=3)
        assert ckpt.maybe_save(3, {"step": 3, "arrays": arrays})
        with np.load(tmp_path / "step_3.npz", allow_pickle=False) as f:
            assert sorted(f.files) == ["arrays/item_factors", "arrays/user_factors", "step"]
        state = StepCheckpointer(str(tmp_path)).restore_latest()
        assert sorted(state) == ["arrays", "step"] and int(state["step"]) == 3
        assert sorted(state["arrays"]) == sorted(arrays)
        for name, a in arrays.items():
            assert state["arrays"][name].dtype == a.dtype
            np.testing.assert_array_equal(state["arrays"][name], a)

    @pytest.mark.parametrize("bad", [
        {"step": 1, "model": object()},
        {"step": 1, "name": "run-7"},
        {"step": 1, "arrays": {"ids": np.asarray(["u1", "u2"])}},
        {"step": 1, "arrays": {"x": np.asarray([1, "a"], dtype=object)}},
        {"step": 1, "arrays": {"a/b": np.zeros(2)}},
        {"step": 1, "arrays": {}},
    ], ids=["object", "string", "text-array", "object-array", "separator", "empty-dict"])
    def test_a_value_that_is_not_numeric_raises_and_writes_nothing(self, tmp_path, bad):
        ckpt = StepCheckpointer(str(tmp_path), every=1)
        with pytest.raises(ValueError):
            ckpt.maybe_save(1, bad)
        assert list(tmp_path.iterdir()) == []
        assert ckpt.restore_latest() is None

    def test_a_flat_state_in_the_earlier_layout_restores(self, tmp_path):
        # a step file as the flat layout writes it: one entry per key
        fp = np.arange(32, dtype=np.uint8)
        X = np.arange(6, dtype=np.float32).reshape(2, 3)
        with open(tmp_path / "step_4.npz", "wb") as f:
            np.savez(f, iteration=np.asarray(4), X=X, fingerprint=fp)
        state = StepCheckpointer(str(tmp_path)).restore_latest()
        assert sorted(state) == ["X", "fingerprint", "iteration"]
        assert int(state["iteration"]) == 4
        np.testing.assert_array_equal(state["X"], X)
        np.testing.assert_array_equal(state["fingerprint"], fp)
        # and a flat state saved now keeps that layout
        StepCheckpointer(str(tmp_path), every=1).maybe_save(5, {"iteration": 5, "X": X})
        with np.load(tmp_path / "step_5.npz", allow_pickle=False) as f:
            assert sorted(f.files) == ["X", "iteration"]


class TestALSCheckpointResume:
    @pytest.mark.parametrize("kw", [{}, dict(compute_dtype="bfloat16"),
                                    dict(implicit_prefs=True, solver="subspace", block_size=2)],
                             ids=["float32", "bfloat16", "implicit-subspace"])
    def test_resume_matches_uninterrupted(self, tmp_path, kw):
        data = synthetic()
        full = train(data, config(6, **kw))
        ckdir = str(tmp_path / "ck")
        train(data, config(3, **kw), ckdir)
        t = {}
        resumed = train(data, config(6, **kw), ckdir, timings=t)
        assert t["checkpoint_resumed_at"] == 3 and len(t["sweep_telemetry"]) == 3
        assert same_bits(full, resumed)

    def test_changed_data_invalidates_checkpoint(self, tmp_path, caplog):
        ckdir = str(tmp_path / "inv")
        train(synthetic(0), config(2), ckdir)
        data2 = synthetic(9)  # new events arrived
        with caplog.at_level(logging.INFO):
            fresh = train(data2, config(2), ckdir)
        assert "different run" in caplog.text
        assert same_bits(fresh, train(data2, config(2)))

    def test_completed_checkpoint_short_circuits(self, tmp_path, caplog):
        data = synthetic()
        ckdir = str(tmp_path / "done")
        first = train(data, config(3), ckdir)
        before = k1.LAUNCHES.snapshot()["normal_eq_plain"]
        with caplog.at_level(logging.INFO):
            again = train(data, config(3), ckdir)
        assert "resuming ALS from iteration 3" in caplog.text
        assert k1.LAUNCHES.snapshot()["normal_eq_plain"] == before
        assert same_bits(first, again)

    def test_a_bf16_config_does_not_resume_a_float32_checkpoint(self, tmp_path, caplog):
        data = synthetic()
        ckdir = str(tmp_path / "dtype")
        train(data, config(3), ckdir)
        with caplog.at_level(logging.INFO):
            bf = train(data, config(3, compute_dtype="bfloat16"), ckdir)
        assert "different run" in caplog.text
        assert same_bits(bf, train(data, config(3, compute_dtype="bfloat16")))

    def test_a_checkpoint_past_the_requested_sweeps_starts_fresh(self, tmp_path, caplog):
        data = synthetic()
        ckdir = str(tmp_path / "past")
        train(data, config(4), ckdir)
        with caplog.at_level(logging.INFO):
            short = train(data, config(2), ckdir)
        assert "exceeds requested 2" in caplog.text
        assert same_bits(short, train(data, config(2)))

    def test_chunks_save_at_the_cadence(self, tmp_path):
        ckdir = tmp_path / "cadence"
        t = {}
        train(synthetic(), config(5), str(ckdir), every=2, timings=t)
        # saves after sweeps 2, 4 and 5; the newest two are kept
        assert sorted(p.name for p in ckdir.iterdir()) == ["step_4.npz", "step_5.npz"]
        assert t["checkpoint_save_s"] > 0 and len(t["sweep_telemetry"]) == 5


def test_train_from_wire_resumes_with_the_wire_as_identity(tmp_path):
    """``train_from_wire`` takes ``checkpoint_dir`` (it raised before
    checkpoints were ported): without ``_fp_material`` the run's identity is
    the wire's bytes."""
    u, i, r = synthetic()
    wire = port_als.build_host_wire(u, i, r, N_USERS, N_ITEMS, config(4))
    full = port_als.train_from_wire(wire, config(4), device="cpu")
    ckdir = str(tmp_path / "wire")
    port_als.train_from_wire(wire, config(2), device="cpu", checkpoint_dir=ckdir,
                             checkpoint_every=1)
    t = {}
    resumed = port_als.train_from_wire(wire, config(4), device="cpu", checkpoint_dir=ckdir,
                                       checkpoint_every=1, timings=t)
    assert t["checkpoint_resumed_at"] == 2 and same_bits(full, resumed)
    state = StepCheckpointer(ckdir).restore_latest()
    want = port_als._run_fingerprint(wire.identity_bytes, config(4), N_USERS, N_ITEMS,
                                     state["X"].shape[0], state["Y"].shape[0])
    assert np.array_equal(state["fingerprint"], want)


def test_a_stripped_wire_checkpoints_only_with_its_fp_material(tmp_path):
    """A stripped wire's planes live on the device, so its bytes would
    hash as empty: a checkpoint through it needs ``_fp_material``, and
    with one it trains and saves under that identity."""
    import dataclasses

    u, i, r = synthetic()
    wire = port_als.build_host_wire(u, i, r, N_USERS, N_ITEMS, config(2))
    device_wire = port_als.upload_wire(wire, port_als.resolve_device("cpu"))
    shell = dataclasses.replace(wire, iw=wire.iw[:0], vw=wire.vw[:0], aux={}, stripped=True)
    ckdir = str(tmp_path / "stripped")
    with pytest.raises(ValueError, match="_fp_material"):
        port_als.train_from_wire(shell, config(2), device_wire=device_wire,
                                 checkpoint_dir=ckdir, checkpoint_every=1)
    material = lambda: b"the entry's identity"  # noqa: E731
    got = port_als.train_from_wire(shell, config(2), device_wire=device_wire,
                                   checkpoint_dir=ckdir, checkpoint_every=1,
                                   _fp_material=material)
    assert same_bits(got, port_als.train_from_wire(wire, config(2), device="cpu"))
    state = StepCheckpointer(ckdir).restore_latest()
    want = port_als._run_fingerprint(material, config(2), N_USERS, N_ITEMS,
                                     state["X"].shape[0], state["Y"].shape[0])
    assert np.array_equal(state["fingerprint"], want)


def _stream(data, batch=70):
    u, i, r = data
    names = np.array([f"u{n}" for n in range(N_USERS)] + [f"i{n}" for n in range(N_ITEMS)],
                     dtype=object)
    t = (i + np.int32(N_USERS)).astype(np.int32)
    batches = [(u[s:s + batch], t[s:s + batch], r[s:s + batch]) for s in range(0, len(r), batch)]
    return ColumnarStream(iter(batches), lambda: names)


def test_train_als_streaming_resumes(tmp_path):
    data = synthetic()
    full = port_streaming.train_als_streaming(_stream(data), config(4), device="cpu", cache=False)
    ckdir = str(tmp_path / "stream")
    port_streaming.train_als_streaming(_stream(data), config(2), device="cpu", cache=False,
                                       checkpoint_dir=ckdir, checkpoint_every=1)
    t = {}
    resumed = port_streaming.train_als_streaming(
        _stream(data), config(4), device="cpu", cache=False, checkpoint_dir=ckdir,
        checkpoint_every=1, timings=t)
    assert t["checkpoint_resumed_at"] == 2
    assert same_bits(full.arrays, resumed.arrays)


@pytest.mark.parametrize("streaming", [False, True], ids=["materialized", "streaming"])
def test_als_algorithm_train_checkpoints_with_the_template_params(tmp_path, caplog, streaming):
    data = synthetic()
    u, i, r = data
    if streaming:
        td = StreamingTrainingData(lambda: _stream(data), None)
    else:
        td = TrainingData(u, i, r, BiMap.int_index([f"u{n}" for n in range(N_USERS)]),
                          BiMap.int_index([f"i{n}" for n in range(N_ITEMS)]))
    base = dict(rank=4, lambda_=0.05, seed=3)

    def fit(iterations, ckdir=None):
        p = ALSAlgorithmParams(num_iterations=iterations, checkpoint_dir=ckdir,
                               checkpoint_every=2, **base)
        return ALSAlgorithm(p).train("cpu", Preparator().prepare("cpu", td)).arrays

    port_streaming.pack_cache_clear()
    full = fit(6)
    ckdir = str(tmp_path / "template")
    fit(4, ckdir)
    with caplog.at_level(logging.INFO):
        resumed = fit(6, ckdir)
    assert "resuming ALS from iteration 4" in caplog.text
    assert same_bits(full, resumed)


def test_a_resident_round_checkpoints_under_its_entry_identity(tmp_path):
    """A resident scatter round trains from a stripped wire: its run is
    identified by the cache entry's fingerprint and cursor, the
    reference's ``_fp_material``, and resumes under it."""
    port_streaming.pack_cache_clear()
    prev = port_streaming.set_resident_training(True)
    try:
        cfg = dict(CFG, rank=8, iterations=4)
        store = seeded_store()
        t = {}
        port_streaming.train_als_streaming(store.stream(ColumnarStream), port_als.ALSConfig(**cfg),
                                           device="cpu", timings=t)
        assert t["resident"] == "cold"
        [entry] = list(port_streaming._PACK_CACHE.values())
        scatterable_delta(store, 40, entry.wire.L_u, entry.wire.L_i)
        ckdir = str(tmp_path / "resident")
        t = {}
        port_streaming.train_als_streaming(store.stream(ColumnarStream), port_als.ALSConfig(**cfg),
                                           device="cpu", timings=t, warm_sweeps=2,
                                           checkpoint_dir=ckdir, checkpoint_every=1)
        assert (t["pack_cache"], t["resident"]) == ("fold", "scatter")
        assert entry.wire.stripped
        state = StepCheckpointer(ckdir).restore_latest()
        want = port_als._run_fingerprint(
            lambda: repr((entry.fingerprint, entry.cursor)).encode(),
            port_als.ALSConfig(**dict(cfg, iterations=2)), entry.wire.n_users,
            entry.wire.n_items, state["X"].shape[0], state["Y"].shape[0],
        )
        assert int(state["iteration"]) == 2 and np.array_equal(state["fingerprint"], want)
        # the same round again (a hit on the resident planes) resumes there
        t = {}
        port_streaming.train_als_streaming(store.stream(ColumnarStream), port_als.ALSConfig(**cfg),
                                           device="cpu", timings=t, checkpoint_dir=ckdir,
                                           checkpoint_every=1)
        assert (t["pack_cache"], t["resident"]) == ("hit", "scatter")
        assert t["checkpoint_resumed_at"] == 2
    finally:
        port_streaming.set_resident_training(prev)
        port_streaming.pack_cache_clear()
