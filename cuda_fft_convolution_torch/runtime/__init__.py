"""Runtime layer: the bank planner (``planner``), the port of
``cuda_fft_convolution_tpu/runtime/planner.py``'s ``BankPlan`` and
``plan_bank``. The JAX package's compiled plans, streams and autotuner are
not ported yet (ROADMAP queue 1 item 7)."""

from cuda_fft_convolution_torch.runtime.planner import BankPlan, plan_bank

__all__ = ["BankPlan", "plan_bank"]
