"""The sampler's launch plan (``ops.sample.plan``) and its statelessness,
on the CPU: pure Python, milliseconds, no engine and no JAX.

- Over B from 1 to 128, V in {1, 50, 32,000, 32,001, 50,257, 152,064}
  and 114 or 132 SMs: the cluster's blocks cover each of a row's V
  entries exactly once (``block_entries``, the kernel's split: the
  row's head before its first 16-byte boundary, whole units in rank
  order, the tail after the last unit), at every head phase 0-3 and for
  every unit a thread may take (1, 2, 4, 8 entries); a cluster has at
  most 16 blocks, and at most the portable 8 unless the plan says it
  needs the non-portable size; the grid has B * cluster blocks, as the
  docstring states; every block keeps at least MIN_SLICE entries where
  the row has them.
- The plan's rule at the card's sizes (132 SMs, V = 32,000): 16 blocks a
  row up to B = 33, one block an SM past that (two a row at B = 64).
- ``ops.sample`` keeps no per-device ticket state, and no tensor at all,
  between launches: the kernel's reduction lives in one launch.
"""

import pytest
import torch

from lir_tpu_torch.ops import sample

VOCABS = (1, 50, 32000, 32001, 50257, 152064)
BATCHES = tuple(range(1, 129))


def _tiles(p, V, head, per_thread):
    """Whether the blocks' ranges tile [0, V): each entry taken once."""
    spans = sorted((r.start, r.stop) for rank in range(p.cluster)
                   for r in sample.block_entries(p, V, rank, head, per_thread)
                   if len(r))
    at = 0
    for start, stop in spans:
        if start != at:
            return False
        at = stop
    return at == V


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("V", VOCABS)
def test_plan_covers_every_entry_once(V, sms):
    for B in BATCHES:
        p = sample.plan(B, V, sms)
        for per_thread in (1, 2, 4, 8):
            for head in range(4):
                assert _tiles(p, V, head, per_thread), (B, p, head, per_thread)


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("V", VOCABS)
def test_plan_cluster_sizes_and_grid(V, sms):
    for B in BATCHES:
        p = sample.plan(B, V, sms)
        assert 1 <= p.cluster <= sample.MAX_CLUSTER
        if not p.non_portable:
            assert p.cluster <= sample.PORTABLE_CLUSTER
        assert p.non_portable == (p.cluster > sample.PORTABLE_CLUSTER)
        assert p.blocks == B * p.cluster
        assert p.slice % sample.SLICE_ALIGN == 0
        assert p.cluster * p.slice >= V
        assert p.cluster == 1 or -(-V // p.cluster) >= sample.MIN_SLICE


def test_plan_rule_at_the_cards_sizes():
    V, sms = 32000, 132
    for B in range(1, 34):
        assert sample.plan(B, V, sms).cluster == 16
    assert sample.plan(34, V, sms).cluster == 132 // 34
    assert sample.plan(64, V, sms) == sample.Plan(2, 16000, 128)
    assert sample.plan(128, V, sms) == sample.Plan(1, 32000, 128)
    assert sample.plan(8, 50, sms) == sample.Plan(1, 56, 8)
    with pytest.raises(ValueError):
        sample.plan(0, V, sms)
    with pytest.raises(ValueError):
        sample.plan(8, 0, sms)


def test_sample_module_keeps_no_launch_state():
    assert not hasattr(sample, "_tickets")
    assert not hasattr(sample, "_TICKETS")
    for name, value in vars(sample).items():
        assert not isinstance(value, torch.Tensor), name
        if isinstance(value, dict):
            assert not any(isinstance(v, torch.Tensor)
                           for v in value.values()), name


def test_cpu_route_is_the_plain_twin():
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((3, 50), generator=gen) * 3
    keys = torch.randint(0, 2**32, (3, 2), generator=gen, dtype=torch.int64)
    offsets = torch.zeros(3, dtype=torch.int64)
    before = sample.gumbel_argmax.launches
    got = sample.gumbel_argmax(logits, keys, offsets, 0.9)
    assert torch.equal(got, sample.gumbel_argmax_plain(logits, keys,
                                                       offsets, 0.9))
    assert sample.gumbel_argmax.launches == before
