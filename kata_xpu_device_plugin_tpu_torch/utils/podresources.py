"""Kubelet pod-resources client (counterpart of
``kata_xpu_device_plugin_tpu/utils/podresources.py``): which pods hold
which devices, for ``status``. The reference ships this as dead code
(``utils/pod_resources.go:41-61``); here it checks that a Kata pod owns the
GPUs it was granted."""
from __future__ import annotations

import grpc

from ..plugin.api import glue
from ..plugin.api import podresources_pb2 as prpb

MAX_MSG = 16 * 1024 * 1024  # the reference's 16 MB cap (:26-28)


def list_pod_resources(
    socket_path: str = glue.POD_RESOURCES_SOCKET, timeout_s: float = 10.0
) -> prpb.ListPodResourcesResponse:
    with grpc.insecure_channel(
        f"unix://{socket_path}",
        options=(("grpc.max_receive_message_length", MAX_MSG),),
    ) as ch:
        grpc.channel_ready_future(ch).result(timeout=timeout_s)
        return glue.PodResourcesListerStub(ch).List(
            prpb.ListPodResourcesRequest(), timeout=timeout_s
        )


def device_assignments(
    resp: prpb.ListPodResourcesResponse, resource_prefix: str = ""
) -> list[dict]:
    """Flatten to [{pod, namespace, container, resource, device_ids}]."""
    out = []
    for pod in resp.pod_resources:
        for container in pod.containers:
            for dev in container.devices:
                if resource_prefix and not dev.resource_name.startswith(resource_prefix):
                    continue
                out.append(
                    {
                        "pod": pod.name,
                        "namespace": pod.namespace,
                        "container": container.name,
                        "resource": dev.resource_name,
                        "device_ids": list(dev.device_ids),
                    }
                )
    return out
