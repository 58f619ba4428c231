"""Known-bad fixture: capture-purity — trace-time impurity inside torch
code that is traced once and replayed."""

import random
import time

import torch


@torch.compile
def step(x):
    return x * time.time()              # folded in at compile time


def jitter(f):
    return f + random.random()          # one sample for every replay


graphed = torch.cuda.make_graphed_callables(jitter, (torch.zeros(4),))


def capture(g, frontier):
    with torch.cuda.graph(g):
        out = frontier * 2
        print("captured", out.shape)    # prints once, at capture
    return out
