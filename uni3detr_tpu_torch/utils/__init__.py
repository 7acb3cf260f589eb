"""Host-side utilities of the port: the BEV drawings of ``cli.test
--show-dir`` (``visualize``) and FLOPs, traces, spans and counters
(``profiling``)."""
