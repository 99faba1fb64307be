"""Optional error reporting and span export: Sentry and OpenTelemetry.

A copy of the JAX package's ``utils_tracing.py``. Both SDKs are optional
dependencies, imported only inside the functions here: without them each
function is a no-op with a warning, so a flag never breaks serving.

OpenTelemetry follows its environment contract (the chart sets these on
engine pods): ``OTEL_EXPORTER_OTLP_ENDPOINT`` turns export on,
``OTEL_SERVICE_NAME`` names the service. The span recorder
(``obs/tracing.py``) mirrors each completed span into the SDK once
``init_otel`` installed a provider.
"""

from __future__ import annotations

import os
from typing import Optional

from .logging_utils import init_logger

logger = init_logger(__name__)

# Set by init_otel: None = never tried, False = tried and degraded (SDK
# missing), True = an SDK TracerProvider is installed.
_otel_state: Optional[bool] = None


def otel_active() -> bool:
    """Whether ``init_otel`` installed an SDK TracerProvider in this
    process: the span recorder mirrors spans only then."""
    return bool(_otel_state)


def reset_otel_state_for_tests() -> None:
    global _otel_state
    _otel_state = None


def init_sentry(dsn: Optional[str], traces_sample_rate: float = 0.0,
                profile_session_sample_rate: float = 0.0) -> bool:
    """Initialize Sentry when a DSN is given and ``sentry_sdk`` imports."""
    if not dsn:
        return False
    try:
        import sentry_sdk
    except ImportError:
        logger.warning("--sentry-dsn set but sentry_sdk is not installed; "
                       "error reporting disabled")
        return False
    sentry_sdk.init(
        dsn=dsn,
        traces_sample_rate=traces_sample_rate,
        profile_session_sample_rate=profile_session_sample_rate,
    )
    logger.info("sentry initialized (traces_sample_rate=%s)",
                traces_sample_rate)
    return True


def init_otel(service_name_default: str) -> bool:
    """Install an OTLP-exporting TracerProvider when
    ``OTEL_EXPORTER_OTLP_ENDPOINT`` is set and the SDK imports.

    Idempotent: a second call returns the first outcome and installs no
    second provider (the SDK would refuse it, and a second span processor
    would export every span twice). An unset endpoint is not cached, so a
    later call may still succeed."""
    global _otel_state
    if _otel_state is not None:
        return _otel_state
    endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
    if not endpoint:
        return False
    try:
        from opentelemetry import trace
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
    except ImportError:
        logger.warning("OTEL_EXPORTER_OTLP_ENDPOINT set but the "
                       "OpenTelemetry SDK is not installed; tracing "
                       "disabled")
        _otel_state = False
        return False
    service = os.environ.get("OTEL_SERVICE_NAME", service_name_default)
    resource = Resource.create({"service.name": service})
    try:
        # The mirror replays spans with the recorder's own ids, so the
        # exported parent links resolve; an SDK without the id_generator
        # keyword exports with random ids.
        from .obs.tracing import MirroredIdGenerator

        provider = TracerProvider(resource=resource,
                                  id_generator=MirroredIdGenerator())
    except TypeError:
        provider = TracerProvider(resource=resource)
    provider.add_span_processor(BatchSpanProcessor(OTLPSpanExporter()))
    trace.set_tracer_provider(provider)
    logger.info("otel tracing initialized: %s -> %s", service, endpoint)
    _otel_state = True
    return True
