"""Tiny cells for the benchmark's CPU tests: the full harness at the
port's tiny configurations, with limits of their own."""

import copy

import torch

from benchmark.harness import common

TESTS = common.BENCH / "tests"
CPU = torch.device("cpu")


def tiny_cell(kind: str) -> dict:
    """``kind`` "serve" or "train": the cell's files by name, as
    ``common.cell`` resolves a cell of BENCHMARK.json."""
    real = {"serve": "serve.vitonhd_b2",
            "train": "train.tryonnet_b5_adam8"}[kind]
    cell = common.cell(real)
    return copy.deepcopy(dict(
        cell, workload=dict(cell["workload"], name=f"tiny.{kind}"),
        config=common.load_json(TESTS / f"tiny_{kind}.json"),
        traffic=common.load_json(TESTS / f"tiny_{kind}_traffic.json"),
        limits=common.load_json(TESTS / "tiny_limits.json")[kind]))
