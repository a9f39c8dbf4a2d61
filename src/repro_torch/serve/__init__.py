"""Serving: the continuous-batching engine (`engine`, slab and paged),
its compiled steps (`capture`), the asyncio streaming front end
(`frontend`) and the TTFT/TPOT metrics ledger (`metrics`)."""
from .engine import (EngineCfg, Request, ServingEngine, StepEvents,
                     TokenEvent)
from .frontend import AsyncFrontend, TokenStream
from .metrics import MetricsLedger, load_trace
