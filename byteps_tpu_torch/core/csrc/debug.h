// Crash diagnostics: print a native backtrace on SIGABRT/SIGSEGV.
// (The reference relies on bare CHECK aborts; symbolised backtraces make
// multi-process topology failures debuggable from captured stderr.)
#pragma once

namespace bps {
// Idempotent; installed at bps_init.
void InstallCrashHandler();
}  // namespace bps
