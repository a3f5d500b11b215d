"""Progressive layer-unfreezing warmup (port of ``diffdock_tpu/train/schedulers.py``;
reference ``layer_linear_warmup``, ``utils/utils.py:131-169`` + ``train.py:35-58``).

- stage 0 (epochs ``[0, warmup_dur)``): only the score heads train;
  parameters under a module named ``batch_norm``/``batchnorm`` never freeze;
- stage ``s`` in ``1..num_conv_layers``: conv layer ``num_conv_layers - s``
  additionally unfreezes (top conv layer first);
- stage ``num_conv_layers + 1``: everything else (the embeddings);
- within every stage the LR ramps linearly ``lr_start_factor -> 1`` over
  ``warmup_dur`` epochs, and each stage transition resets the Adam moments.

Freezing is a 0/1 factor per parameter on the optimizer's update
(``TrainState.param_mask``). The stages are decided on the flax path of
each parameter (:func:`diffdock_tpu_torch.utils.convert.flax_path`), so the
port freezes exactly what the JAX trainer freezes.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Tuple

from diffdock_tpu_torch.utils.convert import flax_path

# score-head modules trainable from stage 0 (reference utils/utils.py:140-142)
HEAD_MODULES = frozenset({
    "center_edge_embedding", "final_conv", "tr_final_layer",
    "rot_final_layer", "final_edge_embedding", "final_tp_tor",
    "tor_bond_conv", "tor_final_dense1", "tor_final_dense2",
})
_CONV_RE = re.compile(r"^conv_(\d+)$")


def unfreeze_stage(path: Tuple[str, ...], num_conv_layers: int) -> int:
    """Smallest warmup stage at which the parameter at flax ``path`` trains."""
    if any("batch_norm" in p.lower() or "batchnorm" in p.lower() for p in path):
        return 0  # BN is never frozen (utils/utils.py:137-139)
    top = path[0]
    if top in HEAD_MODULES:
        return 0
    m = _CONV_RE.match(top)
    if m:
        return num_conv_layers - int(m.group(1))
    return num_conv_layers + 1  # embeddings and everything else release last


def layer_warmup_mask(param_names: Iterable[str], stage: int,
                      num_conv_layers: int) -> Dict[str, float]:
    """0/1 per port parameter name: 1 where the parameter trains at ``stage``."""
    return {
        name: 1.0 if unfreeze_stage(tuple(flax_path(name)), num_conv_layers) <= stage else 0.0
        for name in param_names
    }


@dataclasses.dataclass
class LayerWarmupScheduler:
    """Host-side stage/LR controller. Call ``epoch_update(epoch)`` at the
    start of every epoch; apply the returned stage's mask and LR scale to
    the train state (resetting the Adam moments when ``stage_changed``)."""

    num_conv_layers: int
    warmup_dur: int = 4
    lr_start_factor: float = 0.001
    _stage: int = dataclasses.field(default=-1, init=False)

    @property
    def total_warmup_epochs(self) -> int:
        # reference train.py:38 freeze_params
        return self.warmup_dur * (self.num_conv_layers + 2) - 1

    def epoch_update(self, epoch: int) -> Tuple[int, float, bool]:
        """Returns (stage, lr_scale, stage_changed). A transition fires at
        the top of epoch ``e`` when ``(e+1) % warmup_dur == 0``; from epoch
        ``total_warmup_epochs`` on the scale is 1 and the plateau scheduler
        takes over (reference train.py:45-53)."""
        stage = min((epoch + 1) // self.warmup_dur, self.num_conv_layers + 1)
        changed = stage != self._stage
        self._stage = stage
        if epoch >= self.total_warmup_epochs:
            return stage, 1.0, changed
        # torch LinearLR: factor ramps start->1 over warmup_dur scheduler
        # steps within the current stage (recreated per stage)
        start = 0 if stage == 0 else stage * self.warmup_dur - 1
        k = min(epoch - start, self.warmup_dur)
        frac = k / max(self.warmup_dur, 1)
        scale = self.lr_start_factor + (1.0 - self.lr_start_factor) * frac
        return stage, scale, changed
