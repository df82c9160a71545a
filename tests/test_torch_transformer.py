"""The port's TransformerEncoder against the Flax one, on identical weights.

A 2-layer, hidden-64, 4-head encoder in f32 in both packages; the Flax
parameters cross over through ``models/convert.py``. Logits must agree at
valid positions within 1e-4, which pins LayerNorm's epsilon (1e-6), GELU's
tanh approximation, the DenseGeneral kernel layouts and the tied f32 head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lance_distributed_training_tpu.models.transformer import (
    TransformerEncoder as JaxEncoder,
)
from lance_distributed_training_tpu.ops.flash import (
    make_flash_attention as jax_make_flash_attention,
)
from lance_distributed_training_tpu_torch.models import (
    TransformerEncoder,
    load_flax_params,
    torch_state_dict_from_flax,
)
from lance_distributed_training_tpu_torch.ops.flash import (
    make_flash_attention,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


VOCAB, SEQ, BATCH = 97, 16, 3
DIMS = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
            max_len=SEQ)
LENGTHS = np.array([SEQ, 9, 5])


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, (BATCH, SEQ)).astype(np.int32)
    mask = (np.arange(SEQ)[None, :] < LENGTHS[:, None]).astype(np.int8)
    return ids, mask


def _flax_params(causal=False, seed=0):
    model = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, causal=causal,
                       **DIMS)
    ids, mask = _batch()
    params = model.init(jax.random.key(seed), jnp.asarray(ids),
                        jnp.asarray(mask), train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("arm", ["dense", "flash", "causal"])
def test_logits_match_flax_at_valid_positions(arm):
    causal = arm == "causal"
    params = _flax_params(causal=causal)
    jax_fn = jax_make_flash_attention() if arm == "flash" else None
    port_fn = make_flash_attention() if arm == "flash" else None
    jax_model = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, causal=causal,
                           attention_fn=jax_fn, **DIMS)
    port = TransformerEncoder(VOCAB, dtype=torch.float32, causal=causal,
                              attention_fn=port_fn, **DIMS)
    load_flax_params(port, params)
    ids, mask = _batch(1)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(ids),
                                      jnp.asarray(mask), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (BATCH, SEQ, VOCAB)
    live = mask > 0
    np.testing.assert_allclose(got[live], want[live], atol=1e-4)


def test_converted_state_dict_covers_the_model_exactly():
    port = TransformerEncoder(VOCAB, dtype=torch.float32, **DIMS)
    state = torch_state_dict_from_flax({"params": _flax_params()})
    assert set(state) == set(port.state_dict())
    for name, tensor in port.state_dict().items():
        assert state[name].shape == tensor.shape, name


def test_bf16_compute_keeps_f32_params_and_head():
    port = TransformerEncoder(VOCAB, **DIMS)  # dtype defaults to bf16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    ids, mask = _batch()
    logits = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


def test_init_is_seeded_by_generator():
    a = TransformerEncoder(VOCAB, generator=torch.Generator().manual_seed(3),
                           **DIMS)
    b = TransformerEncoder(VOCAB, generator=torch.Generator().manual_seed(3),
                           **DIMS)
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name

