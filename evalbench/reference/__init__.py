"""The plain reference the benchmark judges the program by.

Plain PyTorch and NumPy only: nothing here imports the program
(``torcheval_tpu_torch``), the JAX package or JAX (``evalbench.guard``
checks the sources). It takes nothing the program made: the inputs and
weights are drawn again from the run's seed (``evalbench.traffic``), and
the program's outputs are read only to be judged.

- :mod:`.ctr`: the CTR eval panel (NE, CTR, calibration, binned and exact
  AUROC and AUPRC), streamed batch by batch in a chosen dtype: float64 for
  the reference, bfloat16 for the control;
- :mod:`.gpt2`: a frozen float32 copy of the GPT-2-width forward equations
  as the configuration runs them, and its float8 control;
- :mod:`.compare`: the numbers compared, as functions of outputs, shared
  by the runs and the controls.
"""
