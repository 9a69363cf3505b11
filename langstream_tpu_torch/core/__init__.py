"""Cross-cutting pieces of the port that every layer may import (stdlib
only): request tracing."""
