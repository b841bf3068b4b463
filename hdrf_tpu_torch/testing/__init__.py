"""Test harnesses: ``minicluster.MiniCluster``, an in-process cluster."""
