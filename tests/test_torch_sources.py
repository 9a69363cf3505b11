"""The port's source agents and Azure code storage against the JAX
package's, on the JAX tests' fakes (loaded by path from
``tests/test_object_storage.py`` and ``tests/test_webcrawler.py``,
unedited; a subclass here only records what a fake is sent):

- ``s3-source`` and ``azure-blob-storage-source``: every case of
  ``tests/test_object_storage.py`` that drives a source or a signer, run
  against the port's modules; and on one fake, both packages' sources give
  equal records, equal deletes on commit and equal request methods, paths,
  queries and bodies (the fakes check the SigV4 envelope and recompute the
  SharedKey signature of every request);
- the port's code storage of ``type: azure`` (and ``s3``) round-trips on
  the fakes, as the JAX one does;
- ``webcrawler``: the cases of ``tests/test_webcrawler.py`` against the
  port, and one crawl of a site with robots rules, a sitemap, a redirect
  and links by both packages: equal records, equal requests, and equal
  frontier state files, which the port resumes from;
- ``local-storage-source``: equal records and deletes."""

import asyncio
import importlib.util
import inspect
import json
import os
from pathlib import Path

import pytest

from langstream_tpu.agents import azure_impl as jax_azure
from langstream_tpu.agents import s3_impl as jax_s3
from langstream_tpu.agents import storage as jax_storage
from langstream_tpu.agents import webcrawler as jax_webcrawler
from langstream_tpu_torch.agents import azure_impl, s3_impl, storage, webcrawler
from langstream_tpu_torch.core import codestorage
from langstream_tpu_torch.serving import s3 as port_s3

REPO = Path(__file__).resolve().parents[1]


def _load(name: str, **rebind):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}_{len(rebind)}",
                                                  REPO / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key, value in rebind.items():
        setattr(module, key, value)
    return module


STORAGE = _load("test_object_storage")
CRAWL = _load("test_webcrawler")
#: cases that call the JAX code storage by import inside the test; the
#: port's code storage has its own round trips below
JAX_ONLY = {"test_s3_code_storage_roundtrip", "test_azure_code_storage_roundtrip"}


@pytest.mark.parametrize("name", [n for n in dir(STORAGE) if n.startswith("test_")
                                  and n not in JAX_ONLY])
def test_the_jax_object_storage_cases_pass_on_the_port(name):
    module = _load("test_object_storage", S3Source=s3_impl.S3Source,
                   SyncS3Client=port_s3.SyncS3Client, sigv4_headers=port_s3.sigv4_headers,
                   AzureBlobSource=azure_impl.AzureBlobSource,
                   parse_connection_string=azure_impl.parse_connection_string,
                   shared_key_headers=azure_impl.shared_key_headers)
    fn = getattr(module, name)
    kwargs = {"run_async": asyncio.run}
    fn(**{p: kwargs[p] for p in inspect.signature(fn).parameters})


class RecordingS3(STORAGE.FakeS3):
    async def handle(self, request):
        self.bodies = getattr(self, "bodies", [])
        self.bodies.append(await request.read())
        return await super().handle(request)


class RecordingAzure(STORAGE.FakeAzureBlob):
    async def handle(self, request):
        self.seen = getattr(self, "seen", [])
        self.seen.append((request.method, request.path_qs, await request.read(),
                          request.headers.get("Content-Type")))
        return await super().handle(request)


def _drive_source(source, config: dict, reads: int):
    async def main():
        await source.init(config)
        await source.start()
        records = []
        for _ in range(reads):
            records += await source.read()
        await source.commit(records)
        await source.close()
        return [(bytes(r.value) if isinstance(r.value, (bytes, bytearray)) else r.value, r.key,
                 list(r.headers)) for r in records]

    return main()


OBJECTS = {"a.txt": b"alpha", "dir/b b.md": b"beta", "c.pdf": b"%PDF-1.4 x",
           "skip.bin": b"\x00", "d+e.html": b"<html>d</html>"}


@pytest.mark.parametrize("extensions", [None, "*", "txt,md"])
def test_s3_source_equals_the_jax_source_on_one_fake(extensions):
    results = {}
    for name, module in (("jax", jax_s3), ("port", s3_impl)):
        async def main():
            fake = await RecordingS3().start()
            try:
                fake.buckets["docs"] = dict(OBJECTS)
                config = {"bucketName": "docs", "endpoint": f"http://127.0.0.1:{fake.port}",
                          "access-key": "ak", "secret-key": "sk", "idle-time": 0.01}
                if extensions:
                    config["file-extensions"] = extensions
                records = await _drive_source(module.S3Source(), config, 6)
                return records, fake.requests, fake.bodies, sorted(fake.buckets["docs"])
            finally:
                await fake.stop()

        results[name] = asyncio.run(main())
    assert results["port"] == results["jax"]
    assert results["port"][0], "no records"


@pytest.mark.parametrize("auth", ["key", "connection-string"])
def test_azure_source_equals_the_jax_source_on_one_fake(auth):
    results = {}
    for name, module in (("jax", jax_azure), ("port", azure_impl)):
        async def main():
            fake = await RecordingAzure().start()
            try:
                fake.containers["inbox"] = dict(OBJECTS)
                config = {"endpoint": f"http://127.0.0.1:{fake.port}", "container": "inbox",
                          "idle-time": 0.01, "file-extensions": "*"}
                if auth == "key":
                    config.update({"storage-account-name": STORAGE.ACCOUNT,
                                   "storage-account-key": STORAGE.ACCOUNT_KEY})
                else:
                    config["storage-account-connection-string"] = (
                        f"AccountName={STORAGE.ACCOUNT};AccountKey={STORAGE.ACCOUNT_KEY}")
                    config["container"] = "fresh"
                records = await _drive_source(module.AzureBlobSource(), config, 6)
                return records, fake.seen, {k: sorted(v) for k, v in fake.containers.items()}
            finally:
                await fake.stop()

        results[name] = asyncio.run(main())
    assert results["port"] == results["jax"]
    assert all(method != "PUT" or ctype == "application/octet-stream"
               for method, _, _, ctype in results["port"][1])


def test_the_ports_azure_and_s3_code_storages_round_trip():
    async def main():
        azure, s3 = await RecordingAzure().start(), await RecordingS3().start()
        try:
            def sync_part():
                ids = []
                for config in (
                        {"type": "azure", "configuration": {
                            "endpoint": f"http://127.0.0.1:{azure.port}", "container": "code",
                            "storage-account-connection-string":
                                f"AccountName={STORAGE.ACCOUNT};AccountKey={STORAGE.ACCOUNT_KEY}"}},
                        {"type": "azure-blob-storage", "configuration": {
                            "endpoint": f"http://127.0.0.1:{azure.port}", "container": "code2",
                            "storage-account-name": STORAGE.ACCOUNT,
                            "storage-account-key": STORAGE.ACCOUNT_KEY}},
                        {"type": "s3", "configuration": {
                            "endpoint": f"http://127.0.0.1:{s3.port}", "bucket-name": "code",
                            "access-key": "ak", "secret-key": "sk"}}):
                    storage_ = codestorage.make_code_storage(config)
                    archive_id = storage_.store("tenant1", "app1", b"zipbytes")
                    assert storage_.download("tenant1", archive_id) == b"zipbytes"
                    storage_.delete("tenant1", archive_id)
                    ids.append(archive_id)
                return ids

            ids = await asyncio.get_running_loop().run_in_executor(None, sync_part)
            assert ids[0].startswith("app1-") and len(set(ids)) == 1
            assert azure.containers == {"code": {}, "code2": {}} and s3.buckets["code"] == {}
            assert [m for m, *_ in azure.seen] == ["HEAD", "PUT", "PUT", "GET", "DELETE"] * 2
        finally:
            await azure.stop()
            await s3.stop()

    asyncio.run(main())
    with pytest.raises(ValueError, match="azure code storage needs sas-token"):
        codestorage.make_code_storage({"type": "azure", "configuration": {"endpoint": "http://x"}})


# ---------------------------------------------------------------------------
# webcrawler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in dir(CRAWL) if n.startswith("test_")])
def test_the_jax_webcrawler_cases_pass_on_the_port(name):
    module = _load("test_webcrawler", WebCrawlerSource=webcrawler.WebCrawlerSource)
    getattr(module, name)(asyncio.run)


class RedirectingSite(CRAWL.FakeSite):
    async def handle(self, request):
        from aiohttp import web

        if request.path == "/old.html":
            self.hits.append(request.path)
            raise web.HTTPMovedPermanently("/b.html")
        return await super().handle(request)


SITE = {
    "/robots.txt": ("text/plain", "User-agent: *\nDisallow: /private\n"
                                  "Sitemap: {base}/sitemap.xml\n"),
    "/sitemap.xml": ("application/xml", '<?xml version="1.0"?><urlset><url><loc>{base}/s.html'
                                        "</loc></url><url><loc>{base}/private/p.html</loc></url>"
                                        "</urlset>"),
    "/": ("text/html", '<html><a href="/a.html">a</a> <a href="old.html#x">old</a>'
                       '<a href="/private/q.html">p</a><a href="mailto:x@y">m</a>'
                       '<a href="http://elsewhere.example/">e</a></html>'),
    "/a.html": ("text/html", '<html>ålpha <a href="/deep/c.html">c</a></html>'),
    "/b.html": ("text/html", "<html>beta</html>"),
    "/deep/c.html": ("text/html", '<html>gamma <a href="/deep/d.html">d</a></html>'),
    "/deep/d.html": ("text/html", "<html>delta</html>"),
    "/s.html": ("text/html", "<html>from the sitemap</html>"),
}


class _Ctx:
    def __init__(self, state: Path | None):
        self.state = state

    def get_persistent_state_directory(self):
        return self.state


def _crawl(module, site, state: Path | None, reads: int, max_depth: int = 2):
    async def main():
        source = module.WebCrawlerSource()
        await source.init({"seed-urls": [f"{site.base}/"],
                           "allowed-domains": [f"127.0.0.1:{site.port}"],
                           "max-depth": max_depth, "min-time-between-requests": 1})
        await source.setup(_Ctx(state))
        await source.start()
        records = []
        for _ in range(reads):
            records += await source.read()
        await source.commit(records)
        await source.close()
        return [(r.value, r.key, list(r.headers)) for r in records]

    return main()


def test_one_crawl_equals_the_jax_crawl_and_resumes(tmp_path):
    results = {}
    for name, module in (("jax", jax_webcrawler), ("port", webcrawler)):
        async def main():
            site = await RedirectingSite({}).start()
            try:
                site.pages.update({p: (ct, body.replace("{base}", site.base))
                                   for p, (ct, body) in SITE.items()})
                state = tmp_path / name
                state.mkdir()
                first = await _crawl(module, site, state, 4)
                saved = json.loads((state / "webcrawler.status.json").read_text())
                rest = await _crawl(module, site, state, 12)
                text = json.dumps([first, saved, rest, site.hits])
                return json.loads(text.replace(site.base, "BASE").replace(str(site.port), "P"))
            finally:
                await site.stop()

        results[name] = asyncio.run(main())
    assert results["port"] == results["jax"]
    first, saved, rest, hits = results["port"]
    urls = [k for _, k, _ in first + rest]
    assert urls == ["BASE/", "BASE/a.html", "BASE/old.html", "BASE/s.html", "BASE/deep/c.html"]
    assert "/private/q.html" not in hits and saved["frontier"]


def test_local_storage_source_equals_the_jax_source(tmp_path):
    results = {}
    for name, module in (("jax", jax_storage), ("port", storage)):
        root = tmp_path / name
        (root / "sub").mkdir(parents=True)
        for file, data in (("a.txt", b"alpha"), ("b.md", b"beta"), ("c.bin", b"\xff\x00"),
                           ("d.txt", b"delta")):
            (root / file).write_bytes(data)
        os.utime(root / "a.txt", (1, 1))
        for config in ({"path": str(root), "extensions": ["txt", "bin"], "idle-time": 0.01,
                        "delete-on-commit": False},
                       {"path": str(root), "idle-time": 0.01}):
            records = asyncio.run(_drive_source(module.LocalStorageSource(), config, 2))
            results.setdefault(name, []).append(
                (json.loads(json.dumps(records, default=repr).replace(str(root), "ROOT")),
                 sorted(p.name for p in root.rglob("*"))))
    assert results["port"] == results["jax"]
    assert results["port"][1][1] == ["sub"]
