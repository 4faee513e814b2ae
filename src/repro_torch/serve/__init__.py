"""Serving: the continuously batched loop (``serve.scheduler``), the
``SketchService`` front end with its stream sessions (``serve.engine``) and
the synthetic traffic generator (``serve.traffic``)."""
