"""Runs of the shrunken cells on the CPU, the harness's look for a card
skipped: sound runs come out correct, and each fault a cell can have,
planted under the timed path, makes ``correct`` false."""

import pytest

from omnibench import harness


def correct(out):
    return all(c.ok for c in out.checks)


@pytest.mark.parametrize("workload", ["roam360-train", "roam360-render"])
def test_sound_runs_are_correct(tiny, workload):
    _, out = tiny(workload)
    assert correct(out), [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0 and out.failed == 0


def _unchanged_state(monkeypatch):
    from omnigs_torch.model import optimizer

    monkeypatch.setattr(optimizer, "adam_step", lambda *a, **k: None)


def _half_the_pixels(monkeypatch):
    """The loss over the top half of the rows, the mean taken over them."""
    from omnigs_torch.ops import loss

    l1, ssim = loss.l1_loss, loss.ssim

    def half(f):
        return lambda a, b, *r, **k: f(a[:, : a.shape[1] // 2], b[:, : b.shape[1] // 2], *r, **k)

    monkeypatch.setattr(loss, "l1_loss", half(l1))
    monkeypatch.setattr(loss, "ssim", half(ssim))


def _one_row_a_window(monkeypatch):
    """Every step of a window reads the window's first staged row."""
    from omnigs_torch.train import trainer

    real = trainer.train_steps_fused

    def first_row(*a, rows, **k):
        return real(*a, rows=[rows[0]] * len(rows), **k)

    monkeypatch.setattr(trainer, "train_steps_fused", first_row)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_pixels, _one_row_a_window])
def test_train_faults_are_caught(tiny, monkeypatch, fault):
    fault(monkeypatch)
    _, out = tiny("roam360-train")
    assert not correct(out), [(c.name, c.value, c.limit) for c in out.checks]


def _altered_pixel(monkeypatch):
    from omnigs_torch.train import renderer

    real = renderer.render_model

    def altered(*a, **k):
        res = real(*a, **k)
        img = res.image.clone()
        img[0, 3, 5] += 0.05
        return res._replace(image=img)

    monkeypatch.setattr(renderer, "render_model", altered)


def _half_the_tiles(monkeypatch):
    from omnigs_torch.train import renderer

    real = renderer.render_model

    def half(*a, **k):
        res = real(*a, **k)
        img = res.image.clone()
        img[:, img.shape[1] // 2:] = 0.0
        return res._replace(image=img)

    monkeypatch.setattr(renderer, "render_model", half)


@pytest.mark.parametrize("fault", [_altered_pixel, _half_the_tiles])
def test_render_faults_are_caught(tiny, monkeypatch, fault):
    fault(monkeypatch)
    _, out = tiny("roam360-render")
    assert not correct(out), [(c.name, c.value, c.limit) for c in out.checks]


def test_truncation_is_caught(tiny):
    """A 256-slot instance buffer truncates: the run is not correct
    whatever the images say."""
    _, out = tiny("roam360-render", yaml={"Tpu.max_instances": 256})
    trunc = next(c for c in out.checks if c.name == "truncated")
    assert trunc.value > 0 and not correct(out)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["roam360-train", "roam360-render"])
def test_control_fails_on_the_card(card, workload):
    """The TF32 control at the cell's own size reads not correct on three
    seeds."""
    import time

    from omnibench import control
    from omnibench.drivers.common import Ctx

    cell = harness.find_cell(workload)
    for seed in (1, 2, 3):
        ctx = Ctx(cell, seed, 0.0, False, card, time.perf_counter())
        checks = (control.render_checks(ctx, 128) if cell.traffic["driver"] == "render"
                  else control.train_checks(ctx))
        assert not all(c.ok for c in checks), (workload, seed, checks)
