"""The port's ``ArchConfig`` shapes and counts (configs/base.py) against
the reference's, for all ten architectures at full and reduced size:
``param_count`` / ``active_param_count`` the same integers, ``shape``,
``runnable`` and ``is_subquadratic`` the same answers, and the batch of
``input_specs`` (``meta`` tensors) the shapes and dtypes of the
reference's ``ShapeDtypeStruct``s.  Exact: all of it is integer
arithmetic on the configs."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import LM_SHAPES  # noqa: E402

CASES = [(name, reduced) for name in JARCHS for reduced in (False, True)]


def _pair(name, reduced):
    ours, ref = ARCHS[name], JARCHS[name]
    return (ours.reduced(), ref.reduced()) if reduced else (ours, ref)


@pytest.mark.parametrize("name,reduced", CASES,
                         ids=[f"{n}-{'reduced' if r else 'full'}"
                              for n, r in CASES])
def test_counts_and_shapes_equal_reference(name, reduced):
    ours, ref = _pair(name, reduced)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    assert isinstance(ours.param_count(), int)
    assert ours.is_subquadratic == ref.is_subquadratic
    assert [dataclasses.asdict(s) for s in ours.shapes] == \
        [dataclasses.asdict(s) for s in ref.shapes]
    for s in LM_SHAPES:
        assert dataclasses.asdict(ours.shape(s.name)) == \
            dataclasses.asdict(ref.shape(s.name))
        assert ours.runnable(s.name) == ref.runnable(s.name)
        kind, batch = ours.input_specs(s.name)
        jkind, jbatch = ref.input_specs(s.name)
        assert kind == jkind
        assert set(batch) == set(jbatch)
        for k, t in batch.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(jbatch[k].shape), k
            assert str(t.dtype).removeprefix("torch.") == \
                np.dtype(jbatch[k].dtype).name, k
    with pytest.raises(KeyError):
        ours.shape("no_such_shape")
    with pytest.raises(KeyError):
        ref.shape("no_such_shape")
