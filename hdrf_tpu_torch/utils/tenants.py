"""Per-tenant (client) attribution (port of hdrf_tpu/utils/tenants.py:35,
the name of the tenant an op without a ``_client`` id belongs to).

The reference tags every RPC and data-transfer op with the client's
self-reported ``_client`` id; ops without one are attributed to
``DEFAULT_TENANT``.  The admission controller and its fair queue
(utils/qos.py) read it.  The reference's ``TenantTracker`` (per-tenant op
and byte counters, rolling latency windows) serves the DataNode's status
surfaces and comes with the DataNode slice.
"""

DEFAULT_TENANT = "anon"  # ops arriving without a _client id
