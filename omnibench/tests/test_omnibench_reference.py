"""The plain reference against omnigs_torch's CPU paths at a tiny size:
renders, gradients, SSIM, Adam, the scene extent and the keyframe
sampler."""

import numpy as np
import pytest
import torch

from omnibench import scene as S
from omnibench.drivers import common as C
from omnibench.reference import render as R, train as RT

W, H = 64, 32


def _scene(seed, n=300):
    truth = S.truth_model(n, seed, "cpu")
    poses = S.poses(3, seed, 3, 0.1, 0.5)
    return truth, [C.pose_tensors(p, "cpu") for p in poses]


def _port_render(raw, vm, cp, sh=3, grad=False):
    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.config import raster_config_from
    from omnigs_torch.config import Config
    from omnigs_torch.train.renderer import render_model

    model = C.port_model(raw, raw["xyz"].shape[0], "cpu")
    cfg = raster_config_from(Config())
    res = render_model(model, Camera(CameraType.LONLAT, W, H), vm, cp, torch.zeros(3), sh, cfg)
    return model, res


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_matches_the_port(seed):
    truth, views = _scene(seed)
    for vm, cp in views:
        ref, counts = R.render(truth, W, H, vm, cp, torch.zeros(3), 3)
        _, res = _port_render(truth, vm, cp)
        assert torch.allclose(res.image.detach(), ref, atol=2e-5), float((res.image - ref).abs().max())
        assert counts.pairs > 0 and counts.instances > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_gradients_match_the_port(seed):
    """The gradient of a smooth loss of the image (a random linear one)
    matches leaf by leaf; the training loss's value matches. (L1's
    gradient flips sign where the image meets the ground truth, so a
    last-bit difference of the two images moves single Gaussians' L1
    gradients.)"""
    from omnigs_torch.ops import loss as port_loss

    truth, views = _scene(seed)
    start = S.start_state(truth, seed)
    vm, cp = views[0]
    weights = torch.randn(3, H, W, generator=torch.Generator().manual_seed(seed))
    _, grads = R.render_loss_grad(start, W, H, vm, cp, torch.zeros(3), 3,
                                  lambda img: (img * weights).sum())
    model, res = _port_render(start, vm, cp)
    (res.image * weights).sum().backward()
    n = start["xyz"].shape[0]
    for k in C.PARAMS:
        got = getattr(model, k).grad[:n]
        assert float((got - grads[k]).norm()) <= 1e-4 * float(grads[k].norm()), k
    gt, _ = R.render(truth, W, H, vm, cp, torch.zeros(3), 3)
    loss, _ = R.render_loss_grad(start, W, H, vm, cp, torch.zeros(3), 3, RT.loss_fn(gt, 0.2, 2))
    pred, ref = res.image.detach()[:, :-2], gt[:, :-2]
    total = 0.8 * port_loss.l1_loss(pred, ref) + 0.2 * (1.0 - port_loss.ssim(pred, ref))
    assert abs(float(total) - float(loss)) <= 1e-5 * abs(float(loss))


def test_ssim_and_adam_match_the_port():
    from omnigs_torch.model import optimizer as port_opt
    from omnigs_torch.ops import loss as port_loss

    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(3, 40, 56, generator=g), torch.rand(3, 40, 56, generator=g)
    assert abs(float(RT.ssim(a, b)) - float(port_loss.ssim(a, b))) < 1e-6
    params = {k: torch.randn(5, 3, generator=g) for k in RT.PARAMS}
    grads = {k: torch.randn(5, 3, generator=g) for k in RT.PARAMS}
    mine = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    state = port_opt.init_adam(params)
    state.count.fill_(41)
    opt = dict(position_lr_init=1.6e-4, position_lr_final=1.6e-6, position_lr_max_steps=30000,
               feature_lr=2.5e-3, opacity_lr=0.05, scaling_lr=5e-3, rotation_lr=1e-3)
    lrs = port_opt.group_lrs(port_opt.LRConfig(), 2.0, torch.tensor(3001))
    port_opt.adam_step(params, grads, state, lrs, torch.ones(5, dtype=torch.bool))
    RT.adam(mine, grads, mu, nu, 42, RT.learning_rates(opt, 2.0, 3001))
    for k in RT.PARAMS:
        assert torch.allclose(params[k], mine[k], rtol=1e-5, atol=1e-6), k


def test_extent_and_sampler_match_the_port():
    from omnigs_torch.scene.scene import KeyframeSampler

    poses = S.poses(16, 7, 3, 0.1, 0.5)
    imgs = [torch.zeros(3, 2, 2)] * 16
    sc = _port_scene(poses, imgs)
    assert sc.nerfpp_norm()[1] == pytest.approx(RT.scene_extent([S.campos(*p) for p in poses]))
    s = KeyframeSampler(sc, 1, 98765432109)
    assert [s.sample().fid for _ in range(40)] == C.sampler_fids(98765432109, range(16), 40)


def _port_scene(poses, imgs):
    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.scene.keyframe import Keyframe
    from omnigs_torch.scene.scene import Scene

    sc = Scene()
    for fid, ((rot, t), img) in enumerate(zip(poses, imgs)):
        sc.add_keyframe(Keyframe(fid, Camera(CameraType.LONLAT, 2, 2), rot, t,
                                 image=np.zeros((2, 2, 3), np.float32)))
    return sc
