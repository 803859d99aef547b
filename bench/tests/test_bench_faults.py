"""The check catches each fault a cell can have: the timed path is
broken underneath (in the program) and a run, its look for a card
skipped, comes out not correct. Tiny sizes on the CPU."""

import copy

import numpy as np
import pytest
import torch
from tiny import SEED, tiny

from benchlib.runner import run_cell


def unchanged_step(trainer, minibatches):
    """A step that returns the model's state unchanged."""
    losses = [float(trainer.model.loss_and_grads(*trainer._features_of(mb), aggregated=True)[0])
              for mb in minibatches]
    return float(np.mean(losses))


def make_half_batch(original):
    def loss_and_grads(self, x_seed, x_n1, x_n2, labels, aggregated=False):
        h = len(labels) // 2
        return original(self, x_seed[:h], x_n1[:h], x_n2[:h], labels[:h], aggregated)
    return loss_and_grads


def no_exchange_step(trainer, minibatches):
    """Each PE's gradient stays its own: PE 0's alone is applied."""
    model = trainer.model
    loss, grads = model.loss_and_grads(*trainer._features_of(minibatches[0]), aggregated=True)
    with torch.no_grad():
        for prm, g in zip(model.parameters(), grads):
            prm.sub_(trainer.lr * g)
    return float(loss)


def make_altered_sample(original):
    def sample_all_raw(self, seed_blocks, rng):
        minibatches, touched = original(self, seed_blocks, rng)
        last = minibatches[1].layer_nbrs[1]
        last[0, 0] = (last[0, 0] + 1) % self.graph.num_nodes
        touched[1, -last.size] = last[0, 0]
        return minibatches, touched
    return sample_all_raw


def make_altered_rows(original):
    def gather_batch(self, id_lists, device=False):
        out = original(self, id_lists, device)
        for block in out.blocks:
            if len(block):
                block[0, 0] += 1.0
                break
        return out
    return gather_batch


def make_buffer_lost(original):
    calls = [0]

    def run(self):
        """Every call after the first starts from an empty buffer."""
        calls[0] += 1
        if calls[0] > 1:
            self.engine.valid[:] = False
        return original(self)
    return run


def make_rng_reset(original):
    start = []

    def run(self):
        """Every call draws its fanouts as the first did: the generator
        is put back to its state at the first call's start."""
        if not start:
            start.append(copy.deepcopy(self.rng.bit_generator.state))
        else:
            self.rng.bit_generator.state = copy.deepcopy(start[0])
        return original(self)
    return run


def make_skipping_agent(original):
    def generate(self, prompt, metrics, history, graph, recent_hits):
        """The agent answers skip to every request."""
        return '{"action": "skip", "expected_hits": "flat", "reason": "fault"}'
    return generate


def make_skipped_round(original):
    def step(self, metrics_list):
        """PE 0 skips the replacement round of a call's third step."""
        decisions, stalls = original(self, metrics_list)
        if self._now == 3:
            decisions = decisions.copy()
            decisions[0] = False
        return decisions, stalls
    return step


def faults():
    from repro_torch.core import backends, controller
    from repro_torch.gnn import sage
    from repro_torch.gnn import train
    from repro_torch.graph import sampler
    from repro_torch.runtime import driver
    from repro_torch.store import feature_store

    return {
        "unchanged": (driver, "train_step", lambda f: unchanged_step, "change_gap_median"),
        "half_batch": (sage.GraphSAGE, "loss_and_grads", make_half_batch, "loss_gap"),
        "no_exchange": (driver, "train_step", lambda f: no_exchange_step, "grad_gap_median"),
        "altered_sample": (sampler.SamplerPlane, "sample_all_raw", make_altered_sample,
                           "sample_mismatch"),
        "altered_rows": (feature_store.FeatureStore, "gather_batch", make_altered_rows,
                         "store_mismatch"),
        # Faults carried from one call to the next.
        "buffer_lost": (train.DistributedTrainer, "run", make_buffer_lost, "engine_mismatch"),
        "rng_reset": (train.DistributedTrainer, "run", make_rng_reset, "sample_mismatch"),
        "skipping_agent": (backends.ICLSurrogateBackend, "generate", make_skipping_agent,
                           "decision_mismatch"),
        "skipped_round": (controller.DecisionPlane, "step", make_skipped_round,
                          "decision_mismatch"),
    }


CASES = [("products-rudder", f) for f in ("unchanged", "half_batch", "no_exchange",
                                          "altered_sample")]
CASES += [("papers-store-rudder", "altered_rows"), ("products-distdgl", "no_exchange"),
          ("products-rudder", "buffer_lost"), ("products-rudder", "rng_reset"),
          ("products-rudder", "skipping_agent")]
CASES += [("products-fixed", f) for f in ("half_batch", "altered_sample", "skipped_round")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    owner, attr, make, number = faults()[fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = run_cell(tiny(cell), SEED + 9, 0.2, False, device="cpu")
    assert not out.correct
    check = out.checks[number]
    assert check["value"] > check["limit"], (number, check)
