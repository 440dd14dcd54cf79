"""Hand-written gRPC service/stub bindings over the generated pb2 messages.

``grpcio-tools`` is not a runtime dependency; the handful of method bindings
the kubelet APIs need are clearer written out than generated. Method paths
(``/v1beta1.DevicePlugin/...``) are the wire contract with the kubelet and
must not change.
"""
from __future__ import annotations

import grpc

from . import deviceplugin_pb2 as pb
from . import podresources_pb2 as prpb

DEVICE_PLUGIN_VERSION = "v1beta1"
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

# Kubelet filesystem contract (ref generic_device_plugin.go:76,201).
KUBELET_SOCKET_DIR = "/var/lib/kubelet/device-plugins"
KUBELET_SOCKET = f"{KUBELET_SOCKET_DIR}/kubelet.sock"
POD_RESOURCES_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"

_REG = "v1beta1.Registration"
_DP = "v1beta1.DevicePlugin"
_PR = "v1alpha1.PodResourcesLister"


class RegistrationServicer:
    """Kubelet-side Register endpoint; subclassed by the fake kubelet in tests."""

    def Register(self, request: pb.RegisterRequest, context) -> pb.Empty:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        return pb.Empty()


def add_registration_to_server(servicer: RegistrationServicer, server: grpc.Server) -> None:
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        )
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(_REG, handlers),))


class RegistrationStub:
    """Client the plugin uses to register with the kubelet
    (ref generic_device_plugin.go:200-219)."""

    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{_REG}/Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )


class DevicePluginServicer:
    """Base for the plugin's kubelet-facing service
    (ref generic_device_plugin.go:222-386)."""

    def GetDevicePluginOptions(self, request: pb.Empty, context) -> pb.DevicePluginOptions:
        return pb.DevicePluginOptions()

    def ListAndWatch(self, request: pb.Empty, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        return iter(())

    def GetPreferredAllocation(
        self, request: pb.PreferredAllocationRequest, context
    ) -> pb.PreferredAllocationResponse:
        return pb.PreferredAllocationResponse()

    def Allocate(self, request: pb.AllocateRequest, context) -> pb.AllocateResponse:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        return pb.AllocateResponse()

    def PreStartContainer(
        self, request: pb.PreStartContainerRequest, context
    ) -> pb.PreStartContainerResponse:
        return pb.PreStartContainerResponse()


def add_device_plugin_to_server(servicer: DevicePluginServicer, server: grpc.Server) -> None:
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=pb.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(_DP, handlers),))


class DevicePluginStub:
    """Client side of the plugin service: used by the kubelet (and our fake
    kubelet tests, and the plugin's own readiness self-dial)."""

    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{_DP}/GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{_DP}/ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{_DP}/GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{_DP}/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{_DP}/PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString,
        )


class PodResourcesListerServicer:
    """Kubelet-side pod-resources service; subclassed by the fake kubelet."""

    def List(self, request: prpb.ListPodResourcesRequest, context) -> prpb.ListPodResourcesResponse:
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        return prpb.ListPodResourcesResponse()


def add_pod_resources_to_server(servicer: PodResourcesListerServicer, server: grpc.Server) -> None:
    handlers = {
        "List": grpc.unary_unary_rpc_method_handler(
            servicer.List,
            request_deserializer=prpb.ListPodResourcesRequest.FromString,
            response_serializer=prpb.ListPodResourcesResponse.SerializeToString,
        )
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(_PR, handlers),))


class PodResourcesListerStub:
    """Client for the kubelet pod-resources API (the reference's dead code,
    utils/pod_resources.go:41-61, made live by the `status` subcommand)."""

    def __init__(self, channel: grpc.Channel):
        self.List = channel.unary_unary(
            f"/{_PR}/List",
            request_serializer=prpb.ListPodResourcesRequest.SerializeToString,
            response_deserializer=prpb.ListPodResourcesResponse.FromString,
        )
