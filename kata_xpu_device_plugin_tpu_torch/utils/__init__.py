"""Host-daemon utilities (counterpart of ``kata_xpu_device_plugin_tpu/utils``):
structured logging, the daemon's Prometheus metrics over the port's
``obs.metrics``, and a ctypes inotify binding. The kubelet pod-resources
client is not ported yet (ROADMAP item 13, step 6)."""
