"""Request tracing and telemetry of the serving path: span trees
(``trace``), the Prometheus families and latency histograms (``metrics``)
and the flight recorder behind ``GET /api/debug/requests`` (``recorder``).
Stdlib only."""
