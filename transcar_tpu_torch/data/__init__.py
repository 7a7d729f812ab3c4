"""Input data for the port: the nuScenes-layout dataset pipeline (copies
of the JAX package's ``infos``, ``pipeline``, ``radar_io``, ``radar``,
``points`` and ``loader``) and the synthetic batches of ``synthetic``."""
