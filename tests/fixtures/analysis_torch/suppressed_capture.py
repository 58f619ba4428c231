"""Suppression fixture: every capture-purity violation here carries an
allow() and the analyzer must report NOTHING for this file."""

import random
import time

import torch


@torch.compile
def step(x):
    # dgraph: allow(capture-purity) fixture: a compile-time constant is
    # what this function wants
    return x * time.time()


def jitter(f):
    return f + random.random()  # dgraph: allow(capture-purity) fixture


graphed = torch.cuda.make_graphed_callables(jitter, (torch.zeros(4),))


def capture(g, frontier):
    with torch.cuda.graph(g):
        out = frontier * 2
        print("captured")  # dgraph: allow(capture-purity) fixture one-off
    return out
