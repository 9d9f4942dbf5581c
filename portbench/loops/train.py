"""Physics training: the port's training step on the physics loss, one job,
closed loop. The configuration's model family builds the step
(families/<family>.py `train_step`: the coordinate MLP through
`train.loop.make_train_step`, the engine "mega" one K4 call a step; the
encoded field through `train.loop.make_ngp_train_step(backward=engine)`,
the encoder, one K5 call, its pull-back); torch.optim.Adam either way. t is
drawn uniform in [0, 1) a step by the program's generator seeded with the
run's seed (TrainConfig's `t_sampling` "uniform"), which the reference
draws again.
"""

from __future__ import annotations

import torch

from portbench.core import program, specs
from portbench.core.training import TrainingJob
from portbench.reference import train as ref


class Job(TrainingJob):
    def build_program(self):
        from phys_autodiff_tpu_torch.train.loop import TrainConfig

        c, tr = self.config, self.traffic
        g, w, model = program.grid_spec(c), program.phys_weights(c), program.model_config(c)
        cfg = TrainConfig(learning_rate=tr["learning_rate"], t_sampling="uniform", seed=self.seed,
                          precision=c["precision"], log_every=tr["read_every"])
        return specs.family(c["family"]).train_step(c, tr, g, w, model, cfg, self.params0)

    def times(self) -> list[float]:
        """The t of each checked step."""
        gen = torch.Generator().manual_seed(self.seed)
        return [float(torch.rand((), generator=gen)) for _ in range(self.traffic["checked_steps"])]

    def reference_loss(self, params, k, prec, keep):
        if not hasattr(self, "_ts"):
            self._ts = self.times()
        return ref.physics_loss_and_grad(self.config, params, self.grid, self.config["weights"], self._ts[k], prec,
                                         keep)
