"""Host-daemon utilities (counterpart of ``kata_xpu_device_plugin_tpu/utils``):
structured logging, the daemon's Prometheus metrics over the port's
``obs.metrics``, a ctypes inotify binding and the kubelet pod-resources
client."""
