"""Request tracing and telemetry of the serving path: span trees
(``trace``), the Prometheus families and latency histograms (``metrics``),
the flight recorder behind ``GET /api/debug/requests`` (``recorder``), the
fleet's trace stitching and freshness stages (``fleetobs``), the on-disk
time-series ring (``timeseries``) and the SLO engine (``slo``). Stdlib
only."""
