"""``simon server`` of the port: the REST server (``rest``), its admission
queue (``admission``) and worker pool (``pool``), the live-cluster
snapshot (``snapshot``), the live twin and its journal (``watch``,
``journal``), the serving fleet and its hot standby (``fleet``) and the
stub apiserver tests and the smoke run list from (``stubapi``)."""
