"""The port's ragged token plane against the JAX package's, bit for bit.

* ``TokenPackPlanner`` plans (FFD and bucket) over 250 seeded length
  vectors with zeros, ties, over-long sequences and n = 1.
* ``TokenDecoder`` in pad, pack and bucket modes: every key and value, the
  waste counters against the JAX registry's, and the same ``ValueError``s.
* K3's plain versions against ``pack_token_batch`` /
  ``unpack_token_batch``, and the whole pack transform against
  ``make_pack_transform``.
* ``create_variable_length_token_dataset``: the same bytes and
  ``Dataset.fingerprint()``; the packed loader's batches and order against
  the JAX iterable loader's.
* ``cuda``-marked tests hold the K3 kernels against the plain versions on
  the card and skip without one.
"""

import re
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from lance_distributed_training_tpu_torch.data import (
    Dataset,
    TokenDecoder,
    TokenPackConfig,
    TokenPackPlanner,
    create_variable_length_token_dataset,
    decoder_for_task,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.data import token_pack
from lance_distributed_training_tpu_torch.data.buffers import BufferPool
from lance_distributed_training_tpu_torch.ops import token_device

# (pack_len, rows_multiple, len_bucket_lo, rows_align)
PLANNER_CONFIGS = [(128, 8, 32, 1), (64, 1, 8, 1), (1024, 8, 32, 1),
                   (100, 3, 16, 2), (8, 2, 32, 4)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's token plane, its K3 and its metrics registry."""
    import types

    jax = pytest.importorskip("jax")
    from lance_distributed_training_tpu.data import authoring, format
    from lance_distributed_training_tpu.data import token_pack as jtp
    from lance_distributed_training_tpu.data.decode import decoder_for_task
    from lance_distributed_training_tpu.data.pipeline import (
        make_train_pipeline,
    )
    from lance_distributed_training_tpu.obs.registry import default_registry
    from lance_distributed_training_tpu.ops import token_device as jtd

    return types.SimpleNamespace(
        jnp=jax.numpy, tp=jtp, td=jtd, authoring=authoring, format=format,
        decoder_for_task=decoder_for_task,
        make_train_pipeline=make_train_pipeline, registry=default_registry())


def _length_vectors(seed: int, count: int, pack_len: int):
    rng = np.random.default_rng(seed)
    out = [[0], [pack_len], [pack_len * 3 + 1], [1, 1, 1], [0, 0, 5, 0]]
    while len(out) < count:
        n = int(rng.integers(1, 70))
        kind = rng.integers(4)
        if kind == 0:  # ties
            lengths = rng.choice([1, pack_len // 2, pack_len // 3 + 1], n)
        elif kind == 1:  # over-long ones
            lengths = rng.integers(0, 2 * pack_len + 5, n)
        elif kind == 2:  # long tail
            lengths = np.clip(rng.lognormal(np.log(pack_len / 6), 0.9, n),
                              0, pack_len).astype(np.int64)
        else:  # zeros among short ones
            lengths = rng.integers(0, 4, n)
        out.append([int(x) for x in lengths])
    return out


def _plans_equal(got, want):
    np.testing.assert_array_equal(got.slot, want.slot)
    np.testing.assert_array_equal(got.start, want.start)
    assert got.slot.dtype == want.slot.dtype == np.int32
    assert got.start.dtype == want.start.dtype == np.int32
    assert (got.rows, got.pack_len, got.payload_tokens,
            got.truncated_tokens) == (want.rows, want.pack_len,
                                      want.payload_tokens,
                                      want.truncated_tokens)
    np.testing.assert_array_equal(got.meta(0), want.meta(0))


@pytest.mark.parametrize("pack_len,rows_multiple,lo,align", PLANNER_CONFIGS)
def test_planner_plans_match_jax(jx, pack_len, rows_multiple, lo, align):
    kw = dict(pack_len=pack_len, rows_multiple=rows_multiple,
              len_bucket_lo=lo, rows_align=align)
    got_cfg, want_cfg = TokenPackConfig(**kw), jx.tp.TokenPackConfig(**kw)
    assert got_cfg.fingerprint() == want_cfg.fingerprint()
    got_planner = TokenPackPlanner(got_cfg)
    want_planner = jx.tp.TokenPackPlanner(want_cfg)
    vectors = _length_vectors(pack_len, 50, pack_len)
    for lengths in vectors + [[]]:
        _plans_equal(got_planner.plan(lengths), want_planner.plan(lengths))
        if lengths:
            _plans_equal(got_planner.plan_bucket(lengths),
                         want_planner.plan_bucket(lengths))


def test_planner_setters_and_helpers_match_jax(jx):
    got, want = TokenPackPlanner(), jx.tp.TokenPackPlanner()
    for value in (3, 8, 200):
        assert got.set_pack_len(value) == want.set_pack_len(value)
    for value in (0, 5):
        assert got.set_rows_multiple(value) == want.set_rows_multiple(value)
    assert got.fingerprint() == want.fingerprint()
    for n in (0, 1, 31, 32, 33, 255, 256, 257, 5000):
        assert token_pack.ragged_capacity(n) == jx.tp.ragged_capacity(n)
        assert token_pack.length_bucket(n) == jx.tp.length_bucket(n)
        assert (token_pack.length_bucket(n, 8, 64)
                == jx.tp.length_bucket(n, 8, 64))
    for name in ("VALUES_SUFFIX", "OFFSETS_SUFFIX", "PACK_SLOT_KEY",
                 "PACK_START_KEY", "PACK_META_KEY", "HOST_META_PREFIX",
                 "PACK_MODE_FFD", "PACK_MODE_BUCKET"):
        assert getattr(token_pack, name) == getattr(jx.tp, name), name
    for key in ("x__values", "x__offsets", "_pack_slot", "_pack_start",
                "_host_pack_meta", "input_ids"):
        assert token_pack.is_ragged_key(key) == jx.tp.is_ragged_key(key)
        assert (token_pack.is_host_meta_key(key)
                == jx.tp.is_host_meta_key(key))


# ------------------------------------------------------------- the decoder


def _ragged_table(seed=0, rows=23, max_len=70, mask=False, fixed=False,
                  second=False):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len, rows)
    lengths[3] = 0
    ids = [rng.integers(2, 500, int(n), dtype=np.int32) for n in lengths]
    cols = {"input_ids": pa.array(ids, pa.list_(pa.int32()))}
    if second:
        cols["labels"] = pa.array([x + 1 for x in ids], pa.list_(pa.int32()))
    if mask:
        cols["attention_mask"] = pa.array(
            [np.ones(int(n), np.int8) for n in lengths], pa.list_(pa.int8()))
    if fixed:
        cols["label"] = pa.array(np.arange(rows), pa.int64())
    return pa.table(cols)


_COUNTERS = token_pack.COUNTER_NAMES


def _jax_counts(jx):
    return {name: jx.registry.counter(name).value for name in _COUNTERS}


def _decode_both(jx, mode, table, seq_len, **cfg):
    planner_kw = {}
    if cfg:
        planner_kw = dict(
            got=TokenPackPlanner(TokenPackConfig(**cfg)),
            want=jx.tp.TokenPackPlanner(jx.tp.TokenPackConfig(**cfg)))
    got_dec = TokenDecoder(mode=mode, seq_len=seq_len,
                           planner=planner_kw.get("got"))
    want_dec = jx.tp.TokenDecoder(mode=mode, seq_len=seq_len,
                                  planner=planner_kw.get("want"))
    assert got_dec.cache_fingerprint() == want_dec.cache_fingerprint()
    before = _jax_counts(jx)
    want = want_dec(table)
    after = _jax_counts(jx)
    got = got_dec(table)
    assert got_dec.counters() == {
        k: int(after[k] - before[k]) for k in _COUNTERS}
    return got, want


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


DECODER_CASES = [
    ("pad", dict(), 32, {}),
    ("pad", dict(mask=True), 16, {}),
    ("pad", dict(fixed=True, second=True), 80, {}),
    ("pack", dict(), 64, {}),
    ("pack", dict(mask=True), 64, {}),
    ("pack", dict(second=True), 32, dict(pack_len=32, rows_multiple=3)),
    ("pack", dict(max_len=300), 128, dict(pack_len=128, rows_multiple=8)),
    ("bucket", dict(fixed=True), 64, {}),
    ("bucket", dict(mask=True, second=True), 16, {}),
]


@pytest.mark.parametrize("mode,table_kw,seq_len,cfg", DECODER_CASES)
def test_token_decoder_matches_jax(jx, mode, table_kw, seq_len, cfg):
    table = _ragged_table(**table_kw)
    got, want = _decode_both(jx, mode, table, seq_len, **cfg)
    _assert_batches_equal(got, want)
    # A RecordBatch and a sliced table decode the same way too.
    got, want = _decode_both(jx, mode, table.to_batches()[0], seq_len, **cfg)
    _assert_batches_equal(got, want)
    got, want = _decode_both(jx, mode, table.slice(5, 11), seq_len, **cfg)
    _assert_batches_equal(got, want)


def test_token_decoder_fixed_size_rows_match_jax(jx):
    ids = np.arange(40, dtype=np.int32).reshape(5, 8)
    mask = (np.arange(8)[None] < np.array([8, 3, 5, 1, 0])[:, None])
    table = pa.table({
        "input_ids": pa.FixedSizeListArray.from_arrays(
            pa.array(ids.ravel()), 8),
        "attention_mask": pa.FixedSizeListArray.from_arrays(
            pa.array(mask.astype(np.int8).ravel()), 8)})
    for mode in ("pad", "pack", "bucket"):
        got, want = _decode_both(jx, mode, table, 8)
        _assert_batches_equal(got, want)


def test_token_decoder_errors_match_jax(jx):
    with pytest.raises(ValueError, match="invalid TokenDecoder mode") as got:
        TokenDecoder(mode="ffd")
    with pytest.raises(ValueError) as want:
        jx.tp.TokenDecoder(mode="ffd")
    assert str(got.value) == str(want.value)
    cases = [("pack", _ragged_table(fixed=True))]
    uneven = _ragged_table(second=True)
    rng = np.random.default_rng(3)
    uneven = uneven.set_column(1, "labels", pa.array(
        [rng.integers(0, 9, int(rng.integers(0, 9)), dtype=np.int32)
         for _ in range(uneven.num_rows)], pa.list_(pa.int32())))
    cases += [(mode, uneven) for mode in ("pad", "pack", "bucket")]
    for mode, table in cases:
        with pytest.raises(ValueError) as got:
            TokenDecoder(mode=mode, seq_len=32)(table)
        with pytest.raises(ValueError) as want:
            jx.tp.TokenDecoder(mode=mode, seq_len=32)(table)
        assert str(got.value) == str(want.value)
    # The buffer pool is ported: a pooled decoder leases its pages and
    # emits the JAX decoder's batch.
    pool = BufferPool()
    pooled = TokenDecoder(mode="pack", seq_len=32, buffer_pool=pool)
    _assert_batches_equal(pooled(_ragged_table()),
                          jx.tp.TokenDecoder(mode="pack", seq_len=32)(
                              _ragged_table()))
    assert pool.counters()["ragged_leases"] == 1


def test_decoder_for_task_text_dispatch_matches_jax(jx):
    table = _ragged_table()
    cfg = dict(pack_len=48, rows_multiple=4)
    got_dec = decoder_for_task("causal_lm", seq_len=48,
                               token_pack=TokenPackConfig(**cfg))
    want_dec = jx.decoder_for_task("causal_lm", seq_len=48,
                                   token_pack=jx.tp.TokenPackConfig(**cfg))
    assert got_dec.mode == want_dec.mode == "pack"
    assert got_dec.cache_fingerprint() == want_dec.cache_fingerprint()
    _assert_batches_equal(got_dec(table), want_dec(table))
    got_dec = decoder_for_task("masked_lm", seq_len=48)
    want_dec = jx.decoder_for_task("masked_lm", seq_len=48)
    assert got_dec.mode == want_dec.mode == "pad"
    _assert_batches_equal(got_dec(table), want_dec(table))


# ------------------------------------------------------------- K3 (plain)


def _k3_inputs(table, pack_len, rows_multiple=8, mode="pack"):
    planner = TokenPackPlanner(TokenPackConfig(pack_len=pack_len,
                                               rows_multiple=rows_multiple))
    batch = TokenDecoder(mode=mode, seq_len=pack_len, planner=planner)(table)
    rows, pl = (int(x) for x in batch["_host_pack_meta"][:2])
    arrays = [batch[k] for k in ("input_ids__values", "input_ids__offsets",
                                 "_pack_slot", "_pack_start")]
    return arrays, rows, pl


def _k3_cases():
    cases = []
    for seed, max_len, pack_len, rm, mode in (
            (0, 70, 64, 8, "pack"), (1, 300, 64, 3, "pack"),
            (2, 30, 1024, 8, "pack"), (3, 90, 128, 1, "bucket"),
            (4, 5, 32, 8, "pack")):
        cases.append(_k3_inputs(_ragged_table(seed, max_len=max_len),
                                pack_len, rm, mode))
    one = pa.table({"input_ids": pa.array([np.arange(2, 39, dtype=np.int32)],
                                          pa.list_(pa.int32()))})
    cases.append(_k3_inputs(one, 1024))
    # A nonzero values tail, a negative slot (counted from the grid's end,
    # as JAX's scatter counts it) and offsets that start past 0.
    (values, offsets, slot, start), rows, pl = cases[0]
    tail = np.concatenate([values, np.arange(1, 300, dtype=np.int32)])
    cases.append(([tail, offsets, slot, start], rows, pl))
    solo = np.array([-1], np.int32), np.array([3], np.int32)
    cases.append(([values, np.array([0, 20], np.int32), *solo], 4, 32))
    cases.append(([values, np.array([5, 25], np.int32),
                   np.array([1], np.int32), np.array([7], np.int32)], 3, 32))
    # Plans no planner makes (cases 9-11), then more sequences than the
    # pack kernel's plan chunk takes at once (case 12).
    rng = np.random.default_rng(11)

    def hand(lengths, slot, start, rows, pack_len, first=0):
        offsets = np.concatenate([[first], first + np.cumsum(lengths)])
        page = rng.integers(2, 500, int(offsets[-1]) + 5, dtype=np.int32)
        return ([page, offsets.astype(np.int32), np.asarray(slot, np.int32),
                 np.asarray(start, np.int32)], rows, pack_len)

    # Runs across a row's end: cells [50, 80), [138, 202), [210, 250).
    cases.append(hand([30, 100, 40], [0, 2, 3], [50, 10, 18], 4, 64))
    # 128 cells: slot -1 wraps to [99, 119); slot -5 start 8 lies 24 cells
    # below -128, so its last 8 tokens wrap to [0, 8); slot 4 is past the
    # grid; slot 3 start 24 runs 12 cells past it; empty sequences between.
    cases.append(hand([20, 0, 40, 10, 0, 20, 12], [-1, 0, -5, 4, 0, 3, 1],
                      [3, 0, 8, 0, 0, 24, 0], 4, 32))
    # offsets[0] = 6: positions 0-5 fall to sequence 0 with k < 0.
    cases.append(hand([10, 0, 7], [1, 0, 2], [7, 0, 30], 3, 64, first=6))
    many = pa.table({"input_ids": pa.array(
        [np.arange(2, 2 + m, dtype=np.int32) for m in rng.integers(0, 6, 600)],
        pa.list_(pa.int32()))})
    cases.append(_k3_inputs(many, 64, 1))
    return cases


K3_CASES = 13


@pytest.mark.parametrize("case", range(K3_CASES))
def test_plain_k3_matches_jax_bit_for_bit(jx, case):
    (values, offsets, slot, start), rows, pack_len = _k3_cases()[case]
    jnp = jx.jnp
    want = jx.td.pack_token_batch(
        jnp.asarray(values), jnp.asarray(offsets), jnp.asarray(slot),
        jnp.asarray(start), rows=rows, pack_len=pack_len)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (values, offsets, slot, start)]
    got = token_device.pack_token_batch(*t, rows=rows, pack_len=pack_len)
    for g, w in zip(got[:3], want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[3].numpy(),
                                  (np.asarray(want[1]) > 0).astype(np.int8))
    for capacity in (values.shape[0], values.shape[0] + 7, 3):
        want_page = jx.td.unpack_token_batch(
            want[0], jnp.asarray(offsets), jnp.asarray(slot),
            jnp.asarray(start), capacity=capacity)
        got_page = token_device.unpack_token_batch(
            got[0], *t[1:], capacity=capacity)
        np.testing.assert_array_equal(got_page.numpy(), np.asarray(want_page))


def _pack_constants() -> dict:
    """The pack kernel's tile and plan chunk, read from its source."""
    source = (Path(token_device.__file__).parent / "csrc" /
              "token_pack.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                source).group(1))
            for name in ("kPackThreads", "kPackCells")}


def _pack_kernel_model(values, offsets, slot, start, rows, pack_len):
    """The pack kernel's loop in numpy: a CTA a tile of kPackThreads x
    kPackCells cells, the plan in chunks of kPackThreads sequences, each
    sequence's run cut into the part below 0 (moved up by the cell count)
    and the part inside, the pieces that meet the tile listed in sequence
    order, the last one listed over a cell owning it; then each cell
    written once in all four outputs."""
    const = _pack_constants()
    threads, per = const["kPackThreads"], const["kPackCells"]
    tile = threads * per
    n, cap, cells = len(slot), len(values), rows * pack_len
    end = min(int(offsets[n]), cap) if n else 0
    outs = [np.zeros(cells, np.int64) for _ in range(4)]
    written = np.zeros(cells, np.int64)
    for t0 in range(0, cells, tile):
        t1 = min(t0 + tile, cells)
        pos_of = np.zeros(t1 - t0, np.int64)
        k_of = np.zeros(t1 - t0, np.int64)
        seq_of = np.zeros(t1 - t0, np.int64)
        for base_i in range(0, n, threads):
            pieces = []
            for i in range(base_i, min(base_i + threads, n)):
                lo = int(offsets[i])
                length = min(int(offsets[i + 1]) - lo, pack_len)
                pa_, pb_ = (0 if i == 0 else max(lo, 0)), min(end, lo + length)
                if pa_ >= pb_:
                    continue
                shift = int(slot[i]) * pack_len + int(start[i]) - lo
                da, db = shift + pa_, shift + pb_
                for a, b, pofs in (
                        (max(da, -cells) + cells, min(db, 0) + cells,
                         -(shift + cells)),
                        (da, min(db, cells), -shift)):
                    a, b = max(a, t0), min(b, t1)
                    if a < b:
                        pieces.append((a, b, pofs, lo, i + 1))
            for c in range(t0, t1):  # each thread's cells, every piece
                for a, b, pofs, lo, seq in pieces:
                    if a <= c < b:
                        pos_of[c - t0] = c + pofs
                        k_of[c - t0] = c + pofs - lo
                        seq_of[c - t0] = seq
        owned = seq_of > 0
        cell = slice(t0, t1)
        written[cell] += 1
        outs[0][cell] = np.where(owned, values[np.where(owned, pos_of, 0)], 0)
        outs[1][cell] = seq_of
        outs[2][cell] = np.where(owned, k_of, 0)
        outs[3][cell] = owned
    assert (written == 1).all()
    shape = (rows, pack_len)
    return tuple(o.reshape(shape).astype(t) for o, t in zip(
        outs, (np.int32, np.int32, np.int32, np.int8)))


@pytest.mark.parametrize("case", range(K3_CASES))
def test_pack_kernel_model_matches_jax_bit_for_bit(jx, case):
    """The tile-owner loop of ``token_pack.cu`` gives JAX's outputs."""
    (values, offsets, slot, start), rows, pack_len = _k3_cases()[case]
    jnp = jx.jnp
    want = jx.td.pack_token_batch(
        jnp.asarray(values), jnp.asarray(offsets), jnp.asarray(slot),
        jnp.asarray(start), rows=rows, pack_len=pack_len)
    got = _pack_kernel_model(values, offsets, slot, start, rows, pack_len)
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got[3],
                                  (np.asarray(want[1]) > 0).astype(np.int8))
    if case == K3_CASES - 1:
        assert len(slot) > _pack_constants()["kPackThreads"]


def test_k3_round_trip_returns_the_page():
    (values, offsets, slot, start), rows, pack_len = _k3_cases()[2]
    assert (np.diff(offsets) <= pack_len).all()  # nothing truncated
    t = [torch.from_numpy(a) for a in (values, offsets, slot, start)]
    grid, seg, pos, mask = token_device.pack_token_batch(
        *t, rows=rows, pack_len=pack_len)
    back = token_device.unpack_token_batch(grid, *t[1:],
                                           capacity=values.shape[0])
    assert torch.equal(back, t[0])
    assert int(mask.sum()) == int(offsets[-1]) == int((seg > 0).sum())
    assert mask.dtype == torch.int8 and pos.dtype == torch.int32


def test_k3_wrappers_reject_other_devices_and_count_no_cpu_launch():
    (values, offsets, slot, start), rows, pack_len = _k3_cases()[0]
    t = [torch.from_numpy(a) for a in (values, offsets, slot, start)]
    before = dict(token_device.LAUNCHES)
    token_device.pack_token_batch(*t, rows=rows, pack_len=pack_len)
    assert token_device.LAUNCHES == before
    meta = [x.to("meta") for x in t]
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        token_device.pack_token_batch(*meta, rows=rows, pack_len=pack_len)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        token_device.unpack_token_batch(torch.zeros(2, 2, device="meta"),
                                        *meta[1:], capacity=4)


def _transform_batch(table, pack_len, mode="pack"):
    planner = TokenPackPlanner(TokenPackConfig(pack_len=pack_len,
                                               rows_multiple=4))
    return TokenDecoder(mode=mode, seq_len=pack_len, planner=planner)(table)


@pytest.mark.parametrize("mode,second", [("pack", False), ("pack", True),
                                         ("bucket", False)])
def test_pack_transform_matches_jax(jx, mode, second):
    table = _ragged_table(7, second=second)
    if mode == "bucket":
        # int32: jnp.asarray would narrow an int64 column on the JAX side.
        table = table.append_column("label", pa.array(
            np.arange(table.num_rows), pa.int32()))
    host = _transform_batch(table, 64, mode)
    want_tx = jx.td.make_pack_transform()
    want = want_tx({k: (v if k.startswith("_host_") else jx.jnp.asarray(v))
                    for k, v in host.items()})
    got_tx = token_device.make_pack_transform()
    staged = {k: (v if k.startswith("_host_") else torch.from_numpy(v))
              for k, v in host.items()}
    got = got_tx(staged)
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert got_tx.pack_new_shapes_total == 1
    got_tx(staged)  # the same shape again: no new shape
    assert got_tx.pack_new_shapes_total == 1
    # A padded batch passes through whole.
    padded = {"input_ids": torch.zeros(2, 4, dtype=torch.int32)}
    assert got_tx(padded) is padded
    assert token_device.is_packed_input(host)
    assert not token_device.is_packed_input(padded)


# ------------------------------------------------------------- datasets


def test_variable_length_writers_match_jax(jx, tmp_path):
    kw = dict(rows=300, vocab_size=77, max_len=40, mean_len=9.0, seed=4,
              fragment_size=120, include_mask=True)
    jx.authoring.create_variable_length_token_dataset(str(tmp_path / "jax"),
                                                      **kw)
    create_variable_length_token_dataset(str(tmp_path / "port"), **kw)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files and files == sorted(
        p.relative_to(tmp_path / "port")
        for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "jax" / rel).read_bytes() == \
            (tmp_path / "port" / rel).read_bytes(), rel
    assert (jx.format.Dataset(str(tmp_path / "jax")).fingerprint()
            == jx.format.Dataset(str(tmp_path / "port")).fingerprint())
    assert Dataset(tmp_path / "port").fragment_rows() == [120, 120, 60]


@pytest.mark.parametrize("shuffle,epoch", [(False, 0), (True, 2)])
def test_packed_loader_matches_jax_loader(jx, tmp_path, shuffle, epoch):
    path = str(tmp_path / "ragged")
    create_variable_length_token_dataset(path, rows=90, vocab_size=50,
                                         max_len=60, mean_len=12.0, seed=1,
                                         fragment_size=25)
    cfg = dict(pack_len=64, rows_multiple=2)
    kw = dict(shuffle=shuffle, seed=3, epoch=epoch)
    want = list(jx.make_train_pipeline(
        jx.format.Dataset(path), "batch", 16, 0, 1,
        jx.decoder_for_task("causal_lm", seq_len=64,
                            token_pack=jx.tp.TokenPackConfig(**cfg)), **kw))
    got = list(make_train_pipeline(
        Dataset(path), "batch", 16, 0, 1,
        decoder_for_task("causal_lm", seq_len=64,
                         token_pack=TokenPackConfig(**cfg)), "cpu", **kw))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            arr = g[key] if key.startswith("_host_") else g[key].numpy()
            assert isinstance(arr, np.ndarray)
            np.testing.assert_array_equal(arr, np.asarray(w[key]),
                                          err_msg=key)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(K3_CASES))
def test_k3_kernels_match_plain_on_card(cuda_device, case):
    """Planner-made cases, a values tail and plans made by hand: the
    kernels equal the plain versions bit for bit, on a repeat launch
    too."""
    (values, offsets, slot, start), rows, pack_len = _k3_cases()[case]
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
         for a in (values, offsets, slot, start)]
    before = dict(token_device.LAUNCHES)
    got = token_device.pack_token_batch(*t, rows=rows, pack_len=pack_len)
    again = token_device.pack_token_batch(*t, rows=rows, pack_len=pack_len)
    want = token_device.pack_token_batch_reference(*t, rows=rows,
                                                   pack_len=pack_len)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)
    cap = values.shape[0]
    page = token_device.unpack_token_batch(got[0], *t[1:], capacity=cap)
    assert torch.equal(page, token_device.unpack_token_batch_reference(
        want[0], *t[1:], capacity=cap))
    assert token_device.LAUNCHES["token_pack"] == before["token_pack"] + 2
    assert token_device.LAUNCHES["token_unpack"] == before["token_unpack"] + 1


@pytest.mark.cuda
def test_k3_kernel_input_checks_on_card(cuda_device):
    (values, offsets, slot, start), rows, pack_len = _k3_cases()[0]
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (values, offsets, slot, start)]
    with pytest.raises(TypeError, match="int32"):
        token_device.pack_token_batch(t[0].long(), *t[1:], rows=rows,
                                      pack_len=pack_len)
    with pytest.raises(ValueError, match=r"\[n\+1\]"):
        token_device.pack_token_batch(t[0], t[1][:-1], *t[2:], rows=rows,
                                      pack_len=pack_len)
    with pytest.raises(ValueError, match="on cpu"):
        token_device.pack_token_batch(t[0], t[1].cpu(), *t[2:], rows=rows,
                                      pack_len=pack_len)
