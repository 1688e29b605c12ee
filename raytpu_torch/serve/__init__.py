"""raytpu_torch.serve: model serving on the port's runtime; the port of
:mod:`raytpu.serve`.

A controller, the named actor ``SERVE_CONTROLLER`` in a process of its
own, reconciles declarative app state onto replica processes (its
children, workers of :mod:`raytpu_torch.runtime`); routing is
client-side power-of-two choices over queue-length probes, or by
prefix-cache match (``RAYTPU_PREFIX_ROUTING``), from any process that
holds a handle; responses stream chunk by chunk. Applications compose:
a bound deployment in another's arguments is a ``DeploymentHandle`` in
its replicas. HTTP ingress is a proxy actor on the standard library's
asyncio streams (``serve.start``; handlers get a ``Request``, streams
go out as server-sent events, ``@serve.ingress`` forwards to an ASGI
app), and gRPC ingress a generic byte service. The JAX package's
exports::

    serve.start(host="127.0.0.1", port=8000)
    serve.run(Tokens.bind(), route_prefix="/gen")
    # GET /gen, "Accept: text/event-stream": data: <chunk> ... data: [DONE]

``serve.LLMDeployment`` is a deployment whose target is the port's
:class:`raytpu_torch.inference.serving.LLMDeployment` (imported at first
use: plain serve users need not load the model and engine)::

    handle = serve.run(serve.LLMDeployment.options(num_replicas=2).bind(
        model="llama", model_config=cfg, engine_options=opts))
    for token in handle.generate.remote_streaming(prompt, max_new_tokens=32):
        ...

Prefill/decode disaggregation composes two of them: the decode replica
pulls each prompt's KV pages from the prefill deployment through its
handle::

    prefill = serve.LLMDeployment.options(
        name="llm-prefill", role="prefill").bind(..., role="prefill")
    handle = serve.run(serve.LLMDeployment.options(
        name="llm-decode", role="decode").bind(..., role="decode",
                                               prefill=prefill))
"""

from raytpu_torch.serve.api import (delete, get_app_handle,
                                    get_deployment_handle, ingress, run,
                                    shutdown, start, status)
from raytpu_torch.serve.batching import batch
from raytpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                       HTTPOptions)
from raytpu_torch.serve.deployment import Application, Deployment, deployment
from raytpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from raytpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from raytpu_torch.serve._private.proxy import Request

__all__ = [
    "Application", "AutoscalingConfig", "Deployment", "DeploymentConfig",
    "DeploymentHandle", "DeploymentResponse", "HTTPOptions",
    "LLMDeployment", "Request",
    "batch", "delete", "deployment", "get_app_handle",
    "get_deployment_handle", "get_multiplexed_model_id", "multiplexed",
    "run",
    "ingress", "shutdown", "start", "status",
]

_llm_deployment = None


def __getattr__(name):
    # Lazy: the LLM deployment pulls in the model and the inference stack.
    global _llm_deployment
    if name == "LLMDeployment":
        if _llm_deployment is None:
            from raytpu_torch.inference.serving import LLMDeployment

            _llm_deployment = deployment(LLMDeployment)
        return _llm_deployment
    raise AttributeError(name)
