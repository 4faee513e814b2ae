"""Command-line entry points: ``launch.serve`` (LM generation and sketch
serving), ``launch.train`` (LM training), and the dry run that needs no
card: ``launch.dryrun`` (one arch x shape x mesh cell), ``launch.grid``
(every cell, one subprocess each) and ``launch.report`` (their tables),
on the meshes of ``launch.mesh``."""
