"""The port's parameter init keeps its fp32 transients near one slice.

``Initializer.normal`` draws in fp32 (``trunc_normal_``) and casts to the
parameter's dtype.  Drawn whole, arctic-480b's bf16 expert stack (4.46e9
elements, 8.9 GB) took a 17.8 GB draw, a scaled copy of it and torch's own
temporaries of its size, and building two of its layers in bf16 (55.4 GB of
parameters) did not fit the 80 GB card.  A parameter over
``DRAW_ELEMENTS`` is now drawn a slice of its first dim at a time, in
order; smaller ones draw the same values as before.
"""

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.models import common  # noqa: E402
from repro_torch.models.common import Initializer  # noqa: E402

SHAPE = (4, 64, 48)
SCALE = 0.125


class _Fp32Sizes(TorchDispatchMode):
    """The storages and sizes of the fp32 tensors that ops return."""

    def __init__(self):
        super().__init__()
        self.sizes = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.dtype == torch.float32:
            ptr = out.untyped_storage().data_ptr()
            self.sizes[ptr] = max(self.sizes.get(ptr, 0), out.numel())
        return out


def _draw(shape, seed):
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                generator=torch.Generator().manual_seed(seed))
    return t * SCALE


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_parameter_within_the_slice_size_draws_as_before(dtype):
    p = Initializer(3, "cpu").normal(SHAPE, SCALE, dtype)
    assert p.dtype == dtype and tuple(p.shape) == SHAPE
    assert torch.equal(p.detach(), _draw(SHAPE, 3).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_larger_parameter_is_drawn_a_slice_at_a_time(monkeypatch, dtype):
    per_row = SHAPE[1] * SHAPE[2]
    monkeypatch.setattr(common, "DRAW_ELEMENTS", 3 * per_row // 2)   # one row a slice
    with _Fp32Sizes() as seen:
        p = Initializer(3, "cpu").normal(SHAPE, SCALE, dtype)
    big = [n for n in seen.sizes.values() if n > per_row]
    # no fp32 tensor above a row, but an fp32 parameter itself
    assert big == ([] if dtype == torch.bfloat16 else [p.numel()])
    # the rows, drawn in order from one generator
    gen = torch.Generator().manual_seed(3)
    for row in range(SHAPE[0]):
        t = torch.empty((1,) + SHAPE[1:])
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        assert torch.equal(p.detach()[row:row + 1], (t * SCALE).to(dtype)), row
    assert torch.equal(p.detach(), Initializer(3, "cpu").normal(SHAPE, SCALE, dtype).detach())
