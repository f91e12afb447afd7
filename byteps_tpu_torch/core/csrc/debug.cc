#include "debug.h"

#include <execinfo.h>
#include <signal.h>
#include <unistd.h>

#include <cstdio>

namespace bps {

namespace {

void CrashHandler(int sig) {
  void* frames[64];
  int n = backtrace(frames, 64);
  dprintf(STDERR_FILENO, "[byteps-tpu crash] signal %d, backtrace:\n", sig);
  backtrace_symbols_fd(frames, n, STDERR_FILENO);
  signal(sig, SIG_DFL);
  raise(sig);
}

}  // namespace

void InstallCrashHandler() {
  static bool done = false;
  if (done) return;
  done = true;
  // Prime backtrace's lazy libgcc load now — calling it first inside a
  // SIGABRT handler can deadlock in malloc when the heap is corrupted.
  void* frames[4];
  backtrace(frames, 4);
  signal(SIGABRT, CrashHandler);
  signal(SIGSEGV, CrashHandler);
  signal(SIGBUS, CrashHandler);
  signal(SIGFPE, CrashHandler);
}

}  // namespace bps
