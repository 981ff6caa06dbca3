"""SplitFed (Thapa et al. 2022; pair: ``repro/fed/splitfed.py``): split
learning with federated aggregation.

The model is split at a fixed point (module md2). Gradients flow server ->
client, so each batch is a synchronous round trip (client forward, ``z``
up, server forward and backward, ``grad_z`` down, client backward). The
math equals ordinary backprop through the full model, so training is the
full-model step; only the time profile (``client_time``) differs.
"""
from __future__ import annotations

from repro_torch.fed.base import BaseTrainer

SPLIT_TIER = 1  # 0-based: the client keeps md1..md2, the paper's SplitFed split


class SplitFedTrainer(BaseTrainer):
    name = "splitfed"
    # the per-batch z-up / grad-down round trip is not the codec plane's
    # download/update-upload contract; compressing grad_z would change the
    # backprop math
    supports_codec = False

    def client_time(self, k: int) -> float:
        return self._splitfed_time(k, self.clients[k].n_batches)

    def _splitfed_time(self, cid: int, nb: int) -> float:
        prof = self.env.profile(cid)
        m = SPLIT_TIER
        c_fwd = self.costs.client_flops[m] / 3.0          # fwd is ~1/3 of fwd+bwd
        c_bwd = self.costs.client_flops[m] * 2.0 / 3.0
        per_batch = (
            c_fwd / prof.flops
            + self.costs.z_bytes[m] / prof.bytes_per_s          # z up
            + self.costs.server_flops[m] / self.server_flops    # server fwd+bwd
            + self.costs.z_bytes[m] / prof.bytes_per_s          # grad_z down
            + c_bwd / prof.flops
        )
        model_sync = 2.0 * self.costs.client_param_bytes[m] / prof.bytes_per_s
        return nb * self.local_epochs * per_batch + model_sync
