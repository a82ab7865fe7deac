"""The port's data pipeline against the reference's: byte-equal batches.

``repro_torch.data.pipeline`` is a copy of the reference module (numpy
only), so every batch, packed sequence, mask and segment id must be
byte-equal to the reference's, dtype included.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs import registry as ref_registry
from repro.configs import shapes as ref_shapes
from repro.data import pipeline as RP
from repro_torch.configs import registry as port_registry
from repro_torch.configs import shapes as port_shapes
from repro_torch.data import pipeline as PP


def assert_batches_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


DATA_CASES = {
    "plain": dict(vocab_size=100, seq_len=16, global_batch=2, seed=3),
    "plain_large_vocab": dict(vocab_size=151552, seq_len=33,
                              global_batch=5, seed=0),
    "audio": dict(vocab_size=2048, seq_len=24, global_batch=3, seed=1,
                  n_codebooks=4),
    "vlm": dict(vocab_size=512, seq_len=12, global_batch=2, seed=2,
                n_patches=8, d_model=32),
}


@pytest.mark.parametrize("step", [0, 1, 17, 10**6])
@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_synthetic_batches_are_byte_equal(case, step):
    kw = DATA_CASES[case]
    ref = RP.SyntheticLM(RP.DataConfig(**kw)).batch(step)
    port = PP.SyntheticLM(PP.DataConfig(**kw)).batch(step)
    assert_batches_equal(port, ref)
    assert (port["labels"][:, :-1] == port["tokens"][:, 1:]).all()


def test_data_config_fields_equal_the_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(PP.DataConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(RP.DataConfig)]


def test_iteration_yields_the_step_keyed_batches():
    cfg = dict(vocab_size=64, seq_len=8, global_batch=2, seed=5)
    it = iter(PP.SyntheticLM(PP.DataConfig(**cfg)))
    ref = RP.SyntheticLM(RP.DataConfig(**cfg))
    for step, got in zip(range(4), it):
        assert_batches_equal(got, ref.batch(step))


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_loader_for_every_arch_is_byte_equal(arch, smoke):
    shape_r = dataclasses.replace(ref_shapes.SHAPES["train_4k"], seq_len=8,
                                  global_batch=2)
    shape_p = dataclasses.replace(port_shapes.SHAPES["train_4k"], seq_len=8,
                                  global_batch=2)
    ref = RP.loader_for(ref_registry.get_config(arch, smoke), shape_r, seed=4)
    port = PP.loader_for(port_registry.get_config(arch, smoke), shape_p,
                         seed=4)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    assert_batches_equal(port.batch(2), ref.batch(2))
    big_r = RP.loader_for(ref_registry.get_config(arch, smoke), shape_r,
                          global_batch=3)
    big_p = PP.loader_for(port_registry.get_config(arch, smoke), shape_p,
                          global_batch=3)
    assert big_p.cfg.global_batch == big_r.cfg.global_batch == 3


def _docs(seed: int, n: int, longest: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1000, rng.integers(1, longest + 1))
            for _ in range(n)]


PACK_CASES = {
    "reference_test": ([np.arange(10), np.arange(37), np.arange(5)], 16, 0),
    "exact_fit": ([np.arange(8), np.arange(8)], 8, 0),
    "one_long": ([np.arange(100)], 7, 0),
    "short_docs_pad_9": ([np.arange(3), np.arange(2), np.arange(1)], 16, 9),
    "random": (_docs(0, 25, 40), 32, 0),
    "random_int32_docs": ([d.astype(np.int32) for d in _docs(1, 9, 70)],
                          24, 3),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_documents_is_byte_equal(case):
    docs, seq_len, pad = PACK_CASES[case]
    ref = RP.pack_documents(docs, seq_len, pad_id=pad)
    port = PP.pack_documents(docs, seq_len, pad_id=pad)
    for a, b in itertools.zip_longest(port, ref):
        assert a.dtype == b.dtype == np.int32
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    toks, mask, seg = port
    assert toks.shape[1] == seq_len
    assert int(mask.sum()) == sum(len(d) for d in docs)
