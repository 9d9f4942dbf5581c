"""Physics training: the port's training step on the physics loss, one job,
closed loop. The coordinate MLP through `train.loop.make_train_step`
(`use_fused=True` for the engine "mega": one K4 call a step), the encoded
field through `train.loop.make_ngp_train_step(backward=engine)` (the
encoder, one K5 call, its pull-back); torch.optim.Adam either way. t is
drawn uniform in [0, 1) a step by the program's generator seeded with the
run's seed (TrainConfig's `t_sampling` "uniform"), which the reference
draws again.
"""

from __future__ import annotations

import torch

from portbench.core import program
from portbench.core.training import TrainingJob
from portbench.reference import train as ref


class Job(TrainingJob):
    def build_program(self):
        from phys_autodiff_tpu_torch.train.loop import (
            TrainConfig, make_ngp_train_step, make_train_step, state_from_params,
        )

        c, tr = self.config, self.traffic
        g, w, model = program.grid_spec(c), program.phys_weights(c), program.model_config(c)
        cfg = TrainConfig(learning_rate=tr["learning_rate"], t_sampling="uniform", seed=self.seed,
                          use_fused=tr["engine"] == "mega", precision=c["precision"], log_every=tr["read_every"])
        if c["family"] == "mlp":
            return make_train_step(g, w, model, cfg), state_from_params(cfg, self.params0)
        return make_ngp_train_step(g, w, model, cfg, self.params0, precision=c["precision"], backward=tr["engine"])

    def times(self) -> list[float]:
        """The t of each checked step."""
        gen = torch.Generator().manual_seed(self.seed)
        return [float(torch.rand((), generator=gen)) for _ in range(self.traffic["checked_steps"])]

    def reference_loss(self, params, k, prec, keep):
        if not hasattr(self, "_ts"):
            self._ts = self.times()
        return ref.physics_loss_and_grad(self.config, params, self.grid, self.config["weights"], self._ts[k], prec,
                                         keep)
