"""Web crawler source.

Parity: ``langstream-agent-webcrawler``
(``agents/webcrawler/WebCrawlerSource.java:61,110``): seeded BFS crawl with
allowed-domains, max-depth/max-urls, robots.txt respect, **sitemap
ingestion** (``Sitemap:`` lines in robots.txt enqueue the sitemap; crawled
sitemap XML — urlset or sitemapindex — enqueues its ``<loc>`` entries
instead of being emitted, ``WebCrawler.java:149,361``), and a
**checkpointed frontier** persisted to the agent's state directory
(``:164-199``, ``LocalDiskStatusStorage:430``) so a restarted replica resumes
where it left off. HTML parsing/link extraction uses the stdlib parser
(the reference uses Jsoup; sitemap parsing replaces its crawler-commons).

The port's copy of ``langstream_tpu/agents/webcrawler.py``, on the port's own
client (:func:`langstream_tpu_torch.gateway.wire.open_response`, which follows
redirects as aiohttp does) instead of aiohttp.
"""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse
from html.parser import HTMLParser
from typing import Any

from langstream_tpu_torch.api.agent import AgentSource
from langstream_tpu_torch.api.record import Record, make_record
from langstream_tpu_torch.gateway import wire

logger = logging.getLogger(__name__)


class _LinkExtractor(HTMLParser):
    def __init__(self) -> None:
        super().__init__()
        self.links: list[str] = []

    def handle_starttag(self, tag: str, attrs) -> None:
        if tag == "a":
            for name, value in attrs:
                if name == "href" and value:
                    self.links.append(value)


class WebCrawlerSource(AgentSource):
    """``webcrawler``: emits one record per crawled page (value = HTML,
    headers: url, content_type)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.seed_urls = configuration.get("seed-urls", [])
        self.allowed_domains = configuration.get("allowed-domains", [])
        self.forbidden_paths = configuration.get("forbidden-paths", [])
        self.max_urls = int(configuration.get("max-urls", 1000))
        self.max_depth = int(configuration.get("max-depth", 10))
        self.min_time_between_requests = (
            float(configuration.get("min-time-between-requests", 500)) / 1000.0
        )
        self.user_agent = configuration.get("user-agent", "langstream-tpu-crawler")
        self.handle_robots = bool(configuration.get("handle-robots-file", True))
        # full re-crawl cadence (parity: WebCrawlerSource reindex interval):
        # once the frontier drains, wait this long, then restart from the
        # seeds with a fresh visited set. 0 = crawl once and idle.
        self.reindex_interval = float(
            configuration.get("reindex-interval-seconds", 0)
        )
        self._drained_at: float | None = None
        self._frontier: list[tuple[str, int]] = []
        self._visited: set[str] = set()
        self._robots_disallow: dict[str, list[str]] = {}
        self._headers = {"User-Agent": self.user_agent}

    async def setup(self, context) -> None:
        await super().setup(context)
        self._state_path = None
        state_dir = context.get_persistent_state_directory()
        if state_dir is not None:
            self._state_path = state_dir / "webcrawler.status.json"
            if self._state_path.exists():
                state = json.loads(self._state_path.read_text())
                self._frontier = [tuple(x) for x in state.get("frontier", [])]
                self._visited = set(state.get("visited", []))

    async def start(self) -> None:
        if not self._frontier and not self._visited:
            self._frontier = [(u, 0) for u in self.seed_urls]

    def _save_state(self) -> None:
        if self._state_path is not None:
            self._state_path.write_text(
                json.dumps(
                    {"frontier": self._frontier, "visited": sorted(self._visited)}
                )
            )

    def _allowed(self, url: str) -> bool:
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme not in ("http", "https"):
            return False
        if self.allowed_domains and not any(
            parsed.netloc == d or parsed.netloc.endswith("." + d)
            or url.startswith(d)
            for d in self.allowed_domains
        ):
            return False
        if any(parsed.path.startswith(p) for p in self.forbidden_paths):
            return False
        for disallowed in self._robots_disallow.get(parsed.netloc, []):
            if parsed.path.startswith(disallowed):
                return False
        return True

    async def _load_robots(self, netloc: str, scheme: str) -> None:
        if not self.handle_robots or netloc in self._robots_disallow:
            return
        rules: list[str] = []
        sitemaps: list[str] = []
        try:
            async with await wire.open_response(
                "GET", f"{scheme}://{netloc}/robots.txt", headers=self._headers, timeout=5
            ) as resp:
                if resp.status == 200:
                    text = await resp.text()
                    applies = False
                    for line in text.splitlines():
                        line = line.split("#")[0].strip()
                        if line.lower().startswith("user-agent:"):
                            agent = line.split(":", 1)[1].strip()
                            applies = agent == "*" or agent in self.user_agent
                        elif applies and line.lower().startswith("disallow:"):
                            path = line.split(":", 1)[1].strip()
                            if path:
                                rules.append(path)
                        elif line.lower().startswith("sitemap:"):
                            # sitemap directives are user-agent independent
                            sitemaps.append(line.split(":", 1)[1].strip())
        except Exception as e:
            # unreachable/garbled robots.txt ⇒ crawl unrestricted, per RFC 9309
            logger.debug("robots.txt fetch for %s failed: %s", netloc, e)
        self._robots_disallow[netloc] = rules
        # the first sight of a host's robots.txt enqueues its sitemaps
        # (WebCrawler.java:361) — depth 0: sitemap entries are roots
        for sitemap in sitemaps:
            if sitemap not in self._visited:
                self._frontier.append((sitemap, 0))

    @staticmethod
    def _is_sitemap(url: str, content_type: str, body: str) -> bool:
        path = urllib.parse.urlparse(url).path.lower()
        if path.endswith(".xml") and "sitemap" in path:
            return True
        head = body[:512].lstrip()
        return ("xml" in content_type or path.endswith(".xml")) and (
            "<urlset" in head or "<sitemapindex" in head
        )

    def _ingest_sitemap(self, url: str, body: str, depth: int) -> None:
        """urlset → enqueue page URLs; sitemapindex → enqueue child
        sitemaps. Only the DIRECT ``<loc>`` of each ``<url>``/``<sitemap>``
        entry counts — extension locs (``<image:loc>``, ``<video:loc>``)
        nest one level deeper and must not enqueue media as pages."""
        import xml.etree.ElementTree as ET

        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            return
        for entry in root:  # <url> or <sitemap> elements
            for loc in entry:
                if not loc.tag.endswith("}loc") and loc.tag != "loc":
                    continue
                if not (loc.text or "").strip():
                    continue
                target = urllib.parse.urljoin(url, loc.text.strip())
                if target not in self._visited and self._allowed(target):
                    self._frontier.append((target, depth))

    async def read(self) -> list[Record]:
        if not self._frontier or len(self._visited) >= self.max_urls:
            if self.reindex_interval > 0 and self._visited:
                import time as _time

                now = _time.monotonic()
                if self._drained_at is None:
                    self._drained_at = now
                elif now - self._drained_at >= self.reindex_interval:
                    # reindex: restart from the seeds with fresh state —
                    # including the robots cache, or changed Disallow rules
                    # and sitemap entries would never be re-ingested
                    self._drained_at = None
                    self._visited.clear()
                    self._robots_disallow.clear()
                    self._frontier = [(u, 0) for u in self.seed_urls]
                    self._save_state()
                    return []
            await asyncio.sleep(0.5)
            return []
        self._drained_at = None
        url, depth = self._frontier.pop(0)
        if url in self._visited:
            return []
        self._visited.add(url)
        parsed = urllib.parse.urlparse(url)
        await self._load_robots(parsed.netloc, parsed.scheme)
        if not self._allowed(url):
            return []
        try:
            async with await wire.open_response("GET", url, headers=self._headers, timeout=15) as resp:
                content_type = resp.headers.get("content-type", "")
                body = await resp.text(errors="replace")
        except Exception:
            self._save_state()
            return []
        if self._is_sitemap(url, content_type, body):
            # sitemaps feed the frontier; they are not documents
            self._ingest_sitemap(url, body, depth)
            self._save_state()
            await asyncio.sleep(self.min_time_between_requests)
            return []
        if depth < self.max_depth and "html" in content_type:
            extractor = _LinkExtractor()
            try:
                extractor.feed(body)
            except Exception as e:
                logger.debug("link extraction failed for %s: %s", url, e)
            for link in extractor.links:
                absolute = urllib.parse.urljoin(url, link.split("#")[0])
                if absolute not in self._visited and self._allowed(absolute):
                    self._frontier.append((absolute, depth + 1))
        self._save_state()
        await asyncio.sleep(self.min_time_between_requests)
        return [
            make_record(
                value=body,
                key=url,
                headers={"url": url, "content_type": content_type},
            )
        ]

    async def commit(self, records: list[Record]) -> None:
        self._save_state()
