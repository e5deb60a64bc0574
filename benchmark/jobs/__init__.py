"""Job kinds, one file each, found by the name a workload file gives."""
