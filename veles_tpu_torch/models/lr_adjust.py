"""Learning-rate schedules — the port of ``veles_tpu/models/lr_adjust.py``.

A policy maps the global step to a multiplier on the base learning
rate.  The JAX package traces them on a float32 step inside its step
program; here they run on the host over a float32 0-d tensor, so the
multiplier is the same float32 value.
"""

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


class ConstantLR:
    def __init__(self, **kwargs):
        pass

    def __call__(self, step):
        return 1.0


class StepLR:
    """lr *= gamma every ``step_size`` steps (caffe 'step')."""

    def __init__(self, gamma=0.1, step_size=100000, **kwargs):
        self.gamma = gamma
        self.step_size = step_size

    def __call__(self, step):
        return torch.pow(_f32(self.gamma),
                         torch.floor(_f32(step) / self.step_size))


class ExpLR:
    """lr *= gamma^step (caffe 'exp')."""

    def __init__(self, gamma=0.9999, **kwargs):
        self.gamma = gamma

    def __call__(self, step):
        return torch.pow(_f32(self.gamma), _f32(step))


class InvLR:
    """lr / (1 + gamma*step)^power (caffe 'inv')."""

    def __init__(self, gamma=0.0001, power=0.75, **kwargs):
        self.gamma = gamma
        self.power = power

    def __call__(self, step):
        return torch.pow(1.0 + self.gamma * _f32(step), -self.power)


class CosineLR:
    """Half-cosine decay from 1 to ``floor`` over ``total_steps``, after
    an optional linear warmup to the full multiplier."""

    def __init__(self, total_steps=100000, floor=0.0, warmup=0,
                 **kwargs):
        self.total_steps = total_steps
        self.floor = floor
        self.warmup = warmup

    def __call__(self, step):
        step = _f32(step)
        denom = max(self.total_steps - self.warmup, 1)
        frac = torch.clamp((step - self.warmup) / denom, 0.0, 1.0)
        mult = self.floor + (1.0 - self.floor) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
        if self.warmup:
            mult = torch.where(step < self.warmup, step / self.warmup, mult)
        return mult


SCHEDULES = {"constant": ConstantLR, "step": StepLR, "exp": ExpLR,
             "inv": InvLR, "cosine": CosineLR}


def get_schedule(name, **kwargs):
    if callable(name) and not isinstance(name, str):
        return name
    return SCHEDULES[name](**kwargs)
