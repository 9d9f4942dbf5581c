"""Snapshot fitting: the port's fit step (`train.fit_field.make_fit_step`,
engine "mega": the encoder, one K7 call, its pull-back; torch.optim.Adam)
on one target snapshot that the benchmark makes (traffic `target`), one
job, closed loop.
"""

from __future__ import annotations

from portbench.core import inputs, program
from portbench.core.training import TrainingJob
from portbench.reference import train as ref

TARGETS = {"trig_mix": inputs.trig_mix}


class Job(TrainingJob):
    def build_program(self):
        from phys_autodiff_tpu_torch.train.fit_field import FitTarget, make_fit_step
        from phys_autodiff_tpu_torch.train.loop import TrainConfig

        c, tr = self.config, self.traffic
        self.target = dict(TARGETS[tr["target"]](c["grid"], self.device), t=tr["target_t"])
        cfg = TrainConfig(learning_rate=tr["learning_rate"], seed=self.seed, precision=c["precision"],
                          log_every=tr["read_every"])
        return make_fit_step(
            program.grid_spec(c), program.model_config(c),
            [FitTarget(self.target["sigma"], self.target["u"], self.target["t"])], cfg, params0=self.params0,
            w_data=program.phys_weights(c), engine=tr["engine"], device=self.device)

    def reference_loss(self, params, k, prec, keep):
        return ref.data_loss_and_grad(self.config, params, self.grid, self.config["weights"], self.target, prec, keep)
