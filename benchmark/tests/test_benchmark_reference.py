"""The three places where the reference's frozen copy departs from the
port's plain code, each held to the code it replaces, which stays in the
copy: the descending any_hit to any_hit_flat, the pair resolve to
resolve_batch_plain, the blocked fused pipeline to one block."""

import pytest
import torch

from harness import cell, numbers
from reference import follow

plain = follow.plain()
R = plain.ops.pallas_raster


def test_any_hit_descent_gives_the_flat_bits():
    g = torch.Generator().manual_seed(0)
    T = 2000
    c = torch.rand((T, 1, 3), generator=g) * 2 - 1
    v = (c + 0.05 * torch.randn((T, 3, 3), generator=g)).reshape(-1, 3)
    bvh = plain.ops.bvh.build(v, torch.arange(3 * T).reshape(T, 3),
                              leaf_size=128)
    ro = torch.rand((6000, 3), generator=g) * 2 - 1
    rd = torch.randn((6000, 3), generator=g)
    rd[::7, 0] = 0.0
    want = plain.ops.tracer.any_hit_flat(ro, rd, bvh)
    got = plain.ops.tracer.any_hit(ro, rd, bvh, ray_chunk=999,
                                   pair_chunk=1 << 12)
    assert want.any() and torch.equal(got, want)


def test_pair_resolve_gives_the_batch_resolve(monkeypatch):
    g = torch.Generator().manual_seed(1)
    N, V, T, H, W = 2, 300, 400, 37, 45
    v = torch.randn((N, V, 4), generator=g)
    v[..., 3] = v[..., 3].abs() + 0.5
    v[0, :5, 3] = -0.2
    tri = torch.randint(0, V, (T, 3), generator=g)
    tri[7] = torch.tensor([3, 3, 3])
    monkeypatch.setattr(R, 'PAIR_BUDGET', 500)
    pz = torch.full((N, H, W), -R.BIG)
    pid = torch.zeros((N, H, W), dtype=torch.int32)
    for _ in range(2):
        coef = torch.stack([R._chunk_coefs(x, tri)[0] for x in v])
        rect = torch.stack([R._chunk_rects(R._tri_rects(x, tri, H, W))
                            for x in v])
        za, ia = R.resolve_batch_plain(coef, rect, H, W, pz, pid)
        zb, ib = R.resolve_plain(v, tri, H, W, pz, pid)
        assert (ia > 0).any()
        assert torch.equal(za, zb) and torch.equal(ia, ib)
        pz, pid = torch.where(ia > 0, za, R.BIG), ia


def test_blocked_pipeline_gives_one_block(monkeypatch):
    spec = cell.load_spec('spot.pass2')
    small = dict(train_res=[16, 16], texture_res=[16, 16], batch=2,
                 n_samples=2, probe_res=16)
    whole = follow.follow(spec, 11, 'cpu', 2, small)
    monkeypatch.setattr(plain.ops.pallas_shade, 'PIXEL_BLOCK', 100)
    blocked = follow.follow(spec, 11, 'cpu', 2, small)
    gaps = numbers.gaps(blocked, whole)
    assert gaps['loss_gap'] == 0.0
    assert gaps['grad_gap'] < 1e-6 and gaps['change_gap'] < 1e-6


def test_reference_step_takes_no_step_of_the_copy():
    """The reference's own modules import nothing of the frozen copy: it
    hands them the renderer as an argument."""
    import subprocess
    import sys
    code = ('import sys\nsys.path[:0] = [%r]\n'
            'from reference import step, geometry, neural\n'
            'print(sorted(m for m in sys.modules if "port_plain" in m))'
            % cell.BENCH_DIR)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == '[]'


def test_kuhn_grid_fills_the_cube_with_positive_tets():
    from reference import geometry
    verts, tets = geometry.kuhn_grid(3, 2.0, 'cpu')
    p = verts[tets]
    vol = torch.linalg.det(p[:, 1:] - p[:, :1]) / 6
    assert tets.shape == (6 * 27, 4) and (vol > 0).all()
    assert float(vol.sum()) == pytest.approx(8.0, rel=1e-5)


def test_marching_tets_close_a_sphere_facing_out():
    """A sphere's SDF (norm - radius, as the traffic's) on a grid gives a
    closed surface: every edge in two faces, every face wound toward the
    SDF's positive side (here away from the centre), every vertex near
    the sphere."""
    from reference import geometry
    verts, tets = geometry.kuhn_grid(8, 2.0, 'cpu')
    sdf = torch.linalg.norm(verts, dim=-1) - 0.6
    v, f, uvs, uv_idx = geometry.marching_tets(verts, sdf, tets)
    assert f.shape[0] > 100 and uv_idx.shape == f.shape
    e = torch.sort(torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]),
                   dim=1).values
    _, count = torch.unique(e, dim=0, return_counts=True)
    assert (count == 2).all()
    c = v[f].mean(1)
    n = torch.linalg.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    assert ((n * c).sum(-1) > 0).all()
    r = torch.linalg.norm(v, dim=-1)
    assert float((r - 0.6).abs().max()) < 0.1


def test_adam_follows_pytorchs():
    from reference import step
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn(50, generator=g)
    grads = [torch.randn(50, generator=g) for _ in range(4)]
    a = x0.clone().requires_grad_()
    b = x0.clone().requires_grad_()
    ours = step.Adam([a], 0.03)
    theirs = torch.optim.Adam([b], lr=0.03, betas=step.BETAS,
                              eps=step.ADAM_EPS)
    for i, gr in enumerate(grads):
        a.grad, b.grad = gr.clone(), gr.clone()
        ours.step(step.schedule(500 + i, 0.001, 0))
        for grp in theirs.param_groups:
            grp['lr'] = 0.03 * step.schedule(500 + i, 0.001, 0)
        theirs.step()
    assert torch.allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize('device', ['cpu', 'meta'])
def test_control_rounds_every_product_on_any_device(device):
    """Under the control a product takes its operands rounded to TF32, on
    the CUDA card as on the CPU: the mode does not ask for the device.
    On the CPU the values are checked: the output, and the gradients,
    whose backward products take the output's gradient rounded too."""
    g = torch.Generator().manual_seed(4)
    x0, w0 = torch.randn((5, 7), generator=g), torch.randn((7, 3),
                                                          generator=g)
    x = x0.to(device).requires_grad_()
    w = w0.to(device).requires_grad_()
    with follow.precision(True):
        y = x @ w
        z = torch.nn.functional.linear(x, w.t())
    assert type(y.grad_fn).__name__ == '_OutputBackward'
    assert {type(f[0]).__name__ for f in y.grad_fn.next_functions[0][0]
            .next_functions} == {'_OperandBackward'}
    if device == 'meta':
        return
    xr, wr = follow._round(x0), follow._round(w0)
    assert not torch.equal(xr, x0)
    assert torch.equal(y, xr @ wr)
    assert torch.equal(z, torch.nn.functional.linear(
        xr, wr.t().contiguous()))
    (y * y).sum().backward()
    gy = follow._round(2 * (xr @ wr))
    assert torch.equal(w.grad, xr.t() @ gy)
    assert torch.equal(x.grad, gy @ wr.t())
    with follow.precision(False):
        assert torch.equal(x0 @ w0, torch.mm(x0, w0))
        assert not torch.equal(x0 @ w0, y.detach())


def test_hashgrid_table_has_the_trained_rms():
    from harness import inputs
    nn = inputs.hashgrid_mlp(inputs.generator(2 ** 31 + 5, 'cpu'), 'cpu')
    t = nn['table'].view(inputs.HASH_LEVELS, -1, inputs.HASH_FEATURES)
    rms = t.double().pow(2).mean((1, 2)).sqrt()
    assert torch.allclose(rms, torch.tensor(inputs.TABLE_RMS,
                                            dtype=torch.float64),
                          rtol=2e-3, atol=0)
    lim = torch.tensor(inputs.TABLE_RMS).double() * 3 ** 0.5
    assert (t.abs().amax((1, 2)).double() <= lim * (1 + 1e-6)).all()
    for i, (k, fan_in) in enumerate((('w0', 32), ('w1', 32), ('w2', 32))):
        assert float(nn[k].abs().max()) <= (6 / fan_in) ** 0.5
