"""The PM mesh's gradient kernel (`csrc/pm_mesh.cu`, `ops/pm_gravity.py`
`fd4_gradient_cuda`) against its plain version `fd4_gradient_plain` and
against `roll_form`, the 12-roll gradient of the whole padded cube cropped
to n^3 that the port used before the kernel.

The tests marked `gpu` need a card and skip without one: the kernel equal
to both bit for bit in float32 and float64 on the fd path's padded cube
(L = 2n) and on the pencil solve's ghost-ringed cube (L = n + 4, lead 2),
two launches bit for bit, and one launch counted for each mesh solve.  The
CPU tests of the same functions are in `test_torch_pm_gravity.py`.  No
JAX, so this file runs on a GPU machine without it:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_pm_mesh_kernel.py
"""

import numpy as np
import pytest
import torch

from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.ops import pm_gravity
from summersph_tpu_torch.state import Particles

DTYPES = (torch.float32, torch.float64)


def roll_form(phi, cell, n):
    """F = -grad phi as the port computed it before the kernel: 4 rolls a
    component over the whole cube, each intermediate a cube, then the crop
    to [:n, :n, :n] and the stack to [n, n, n, 3]."""
    comps = []
    for ax in range(3):
        d = (-torch.roll(phi, -2, ax) + 8.0 * torch.roll(phi, -1, ax)
             - 8.0 * torch.roll(phi, 1, ax) + torch.roll(phi, 2, ax)) \
            / (12.0 * cell)
        comps.append(-d)
    return torch.stack([g[:n, :n, :n] for g in comps], dim=-1)


def padded_potential(n, dtype, device, seed=0):
    """A (2n)^3 cube of normal values, its padded half as full as its
    crop, and the 0-d cell of the fd path."""
    g = torch.Generator().manual_seed(seed)
    phi = torch.randn((2 * n,) * 3, generator=g, dtype=torch.float64)
    return (phi.to(dtype).to(device),
            torch.tensor(0.37, dtype=dtype, device=device))


def ghost_cube(phi, n):
    """The pencil solve's ghost-ringed cube cut from a padded cube:
    phi_m[a] = phi[(a - 2) mod 2n] on every axis, a < n + 4."""
    ghost = (torch.arange(n + 4, device=phi.device) - 2) % phi.shape[0]
    return phi[ghost][:, ghost][:, :, ghost].contiguous()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [16, 17, 128])
def test_kernel_equals_plain_and_roll_form(cuda_device, n, dtype):
    phi, cell = padded_potential(n, dtype, cuda_device)
    before = pm_gravity.fd4_gradient_cuda.launches
    got = pm_gravity.fd4_gradient(phi, cell, n)
    torch.cuda.synchronize()
    assert pm_gravity.fd4_gradient_cuda.launches == before + 1
    assert got.shape == (n, n, n, 3) and got.dtype == dtype
    assert torch.equal(got, pm_gravity.fd4_gradient_plain(phi, cell, n))
    assert torch.equal(got, roll_form(phi, cell, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [16, 17, 128])
def test_kernel_on_the_ghost_ringed_cube(cuda_device, n, dtype):
    phi, cell = padded_potential(n, dtype, cuda_device, seed=1)
    phi_m = ghost_cube(phi, n)
    got = pm_gravity.fd4_gradient(phi_m, cell, n, lead=2)
    torch.cuda.synchronize()
    assert torch.equal(got, pm_gravity.fd4_gradient_plain(phi_m, cell, n,
                                                          lead=2))
    assert torch.equal(got, pm_gravity.fd4_gradient(phi, cell, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_launches_equal_bit_for_bit(cuda_device, dtype):
    phi, cell = padded_potential(128, dtype, cuda_device, seed=2)
    a = pm_gravity.fd4_gradient(phi, cell, 128)
    b = pm_gravity.fd4_gradient(phi, cell, 128)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_launch_a_solve(cuda_device, dtype):
    rng = np.random.default_rng(3)
    n_part = 3000
    p = Particles.create(rng.normal(0.0, 10.0, (n_part, 3)),
                         np.zeros((n_part, 3)), np.full(n_part, 1e-3),
                         u=1.0, h=1.0, dtype=dtype, device=cuda_device)
    cfg = SimConfig(gravity="pm", grav_grid=32)
    launches = pm_gravity.fd4_gradient_cuda.launches
    solves = pm_gravity.pm_long_range.solves
    accs = [pm_gravity.pm_long_range(p, cfg)[0] for _ in range(2)]
    torch.cuda.synchronize()
    assert pm_gravity.pm_long_range.solves - solves == 2
    assert pm_gravity.fd4_gradient_cuda.launches - launches == 2
    assert torch.equal(accs[0], accs[1])
    assert bool(torch.isfinite(accs[0]).all())


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    phi, cell = padded_potential(16, torch.float32, cuda_device)
    cases = [(phi.half(), cell.half(), 16, 0, TypeError),
             (phi.transpose(0, 2), cell, 16, 0, ValueError),
             (phi, cell.double(), 16, 0, ValueError),
             (phi, cell, 31, 2, ValueError)]
    for phi_c, cell_c, n, lead, err in cases:
        with pytest.raises(err):
            pm_gravity.fd4_gradient_cuda(phi_c, cell_c, n, lead)
