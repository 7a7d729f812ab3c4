"""Multi-process training and eval, the head's tensor parallelism and
camera-axis sharded serving (``transcar_tpu/parallel``).

``distributed``: process groups from torchrun's or Slurm's environment,
each rank's rows of a global batch, autograd-aware sums and the eval
gather.  ``mesh``: the (data × model) grid of process groups and the
camera-sharded detector.  ``sharding``: the Megatron rule table of the
head's matmuls and the tensor-parallel modules that apply it.
``dryrun``: the multi-rank dry run (``python -m
transcar_tpu_torch.parallel.dryrun N``).
"""
