"""The paper's system in the port: the broker, the DAG IR plane, the
decomposer, scheduler and perf model, the DHT, the compression toolbox
and the execution plane (``executor``), counterparts of ``repro.core``."""
