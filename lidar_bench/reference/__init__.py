"""The benchmark's plain reference of one odometry frame and of the solve.

A frozen copy of the port's frame path (``tloam_torch`` at the commit that
added the benchmark: cloud, config, the models, the ops it uses and the
pipeline front end), with every kernel replaced by its plain torch
version (the edge pick rounds), no stage timers and no device defaults,
cut to what the benchmark's configurations run: no GICP residual, no
process groups, no optional modes of the front end. A configuration that
sets one of those fails here with an unknown field; a later cell brings its
own frozen piece with its limits.
It imports nothing of ``tloam_torch``, ``tloam_tpu`` or JAX, and nothing
of it may be edited to follow the port: the benchmark holds the port
against it.
"""
