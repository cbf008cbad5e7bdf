// aoti_serve: a Python-free loader of the port's serving bundles
// (counterpart of tools/pjrt_serve.c).
//
//   aoti_serve [--hold] <op_lib.so> <model.pt2> <input.bin> <output.bin> <d0,d1,...>
//   aoti_serve --schema <op_lib.so>
//
// contrib.serving.export_pjrt_bundle writes <model.pt2>, an AOTInductor
// package of a .mxtpu artifact's program, and the operator library that
// registers K1 as mxtpu::flash_fwd in C++ (ops/csrc/flash_fwd_op.cpp).
// This program dlopens that library, loads the package with libtorch's
// AOTIModelPackageLoader and runs it twice on the input: <input.bin> holds
// the raw words of each input in turn, in the dtypes the package's metadata
// names (mxtpu_input_dtypes), with the shapes of the last argument (one
// comma-separated shape an input, ';' between inputs). The outputs of the
// second forward go to <output.bin> as raw words, one after another.
// It links libtorch and never libpython.
//
// The package computes on the device it was exported on (its metadata's
// AOTI_DEVICE_KEY, cuda:0 or the CPU); a package the machine cannot run
// exits 1 with the loader's error. Nothing reruns on another device.
//
// Prints, a line each: load_s, forward1_ms, forward2_ms (host clock around
// the run and a synchronisation of the device), k1_launches and
// k1_plain_calls (over both forwards, from the operator library's counters)
// and repeat_equal (the two forwards' outputs bit for bit). With --hold it
// then prints "done" and waits for its standard input to close, so a
// caller can read its /proc/<pid>/maps. --schema prints the registered
// schema of mxtpu::flash_fwd.
#include <dlfcn.h>

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iterator>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using Counter = long long (*)();

int fail(const std::string& what) {
  std::fprintf(stderr, "aoti_serve: FAIL %s\n", what.c_str());
  return 1;
}

std::vector<std::string> split(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::stringstream ss(s);
  std::string item;
  while (std::getline(ss, item, sep)) out.push_back(item);
  return out;
}

at::ScalarType dtype_of(const std::string& name) {
  static const std::unordered_map<std::string, at::ScalarType> table = {
      {"float32", at::kFloat}, {"float64", at::kDouble},  {"float16", at::kHalf},
      {"bfloat16", at::kBFloat16}, {"int64", at::kLong}, {"int32", at::kInt},
      {"int16", at::kShort}, {"int8", at::kChar}, {"uint8", at::kByte},
      {"bool", at::kBool}};
  auto it = table.find(name);
  TORCH_CHECK(it != table.end(), "unknown dtype ", name);
  return it->second;
}

void synchronize(const c10::Device& device) {
  if (device.type() != c10::DeviceType::CPU)
    c10::impl::VirtualGuardImpl(device.type()).synchronizeDevice(device.index());
}

int serve(int argc, char** argv, bool hold, Counter launches, Counter plain) {
  using clk = std::chrono::steady_clock;
  auto ms = [](clk::time_point a, clk::time_point b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };
  const std::string package = argv[1], input = argv[2], output = argv[3];
  const std::vector<std::string> shapes = split(argv[4], ';');

  auto t0 = clk::now();
  torch::inductor::AOTIModelPackageLoader loader(package);
  auto t1 = clk::now();
  auto meta = loader.get_metadata();
  const std::string key = meta["AOTI_DEVICE_KEY"];
  const c10::Device device = key == "cpu" ? c10::Device(c10::DeviceType::CPU)
                                          : c10::Device(key + ":0");
  const std::vector<std::string> dtypes = split(meta["mxtpu_input_dtypes"], ',');
  if (dtypes.size() != shapes.size())
    return fail("the package takes " + std::to_string(dtypes.size()) + " inputs, got " +
                std::to_string(shapes.size()) + " shapes");

  std::ifstream in(input, std::ios::binary);
  if (!in) return fail("cannot read " + input);
  std::vector<char> raw((std::istreambuf_iterator<char>(in)), std::istreambuf_iterator<char>());
  std::vector<at::Tensor> inputs;
  size_t offset = 0;
  for (size_t i = 0; i < shapes.size(); ++i) {
    std::vector<int64_t> sizes;
    for (const auto& d : split(shapes[i], ',')) sizes.push_back(std::atoll(d.c_str()));
    at::Tensor host = at::empty(sizes, at::TensorOptions().dtype(dtype_of(dtypes[i])));
    const size_t nbytes = host.nbytes();
    if (offset + nbytes > raw.size())
      return fail(input + " holds " + std::to_string(raw.size()) + " bytes, fewer than the " +
                  "inputs' shapes and dtypes need");
    std::memcpy(host.data_ptr(), raw.data() + offset, nbytes);
    offset += nbytes;
    inputs.push_back(host.to(device));
  }
  if (offset != raw.size())
    return fail(input + " holds " + std::to_string(raw.size()) + " bytes, not the " +
                std::to_string(offset) + " the inputs' shapes and dtypes need");

  const long long launches0 = launches(), plain0 = plain();
  std::vector<double> forward_ms;
  std::vector<std::vector<at::Tensor>> results;
  for (int i = 0; i < 2; ++i) {
    auto a = clk::now();
    results.push_back(loader.run(inputs));
    synchronize(device);
    forward_ms.push_back(ms(a, clk::now()));
  }
  bool equal = results[0].size() == results[1].size();
  std::FILE* f = std::fopen(output.c_str(), "wb");
  if (!f) return fail("cannot write " + output);
  for (size_t i = 0; i < results[1].size(); ++i) {
    at::Tensor host = results[1][i].contiguous().cpu();
    equal = equal && at::equal(results[0][i].cpu(), host);
    if (std::fwrite(host.data_ptr(), 1, host.nbytes(), f) != host.nbytes()) {
      std::fclose(f);
      return fail("short write to " + output);
    }
  }
  if (std::fclose(f) != 0) return fail("cannot close " + output);
  std::printf("device %s\n", device.str().c_str());
  std::printf("load_s %.6f\n", ms(t0, t1) / 1e3);
  std::printf("forward1_ms %.4f\nforward2_ms %.4f\n", forward_ms[0], forward_ms[1]);
  std::printf("k1_launches %lld\nk1_plain_calls %lld\n", launches() - launches0,
              plain() - plain0);
  std::printf("repeat_equal %s\n", equal ? "true" : "false");
  std::fflush(stdout);
  if (hold) {
    std::printf("done\n");
    std::fflush(stdout);
    while (std::fgetc(stdin) != EOF) {
    }
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const char* usage =
      "usage: aoti_serve [--hold] <op_lib.so> <model.pt2> <input.bin> <output.bin> "
      "<d0,d1,...>\n       aoti_serve --schema <op_lib.so>\n";
  bool hold = false, schema = false;
  if (argc > 1 && !std::strcmp(argv[1], "--hold")) {
    hold = true;
    --argc, ++argv;
  } else if (argc > 1 && !std::strcmp(argv[1], "--schema")) {
    schema = true;
    --argc, ++argv;
  }
  if (argc != (schema ? 2 : 6)) {
    std::fputs(usage, stderr);
    return 2;
  }
  void* op = dlopen(argv[1], RTLD_NOW | RTLD_GLOBAL);
  if (!op) return fail(std::string("dlopen ") + argv[1] + ": " + dlerror());
  auto launches = reinterpret_cast<Counter>(dlsym(op, "mxtpu_flash_fwd_launches"));
  auto plain = reinterpret_cast<Counter>(dlsym(op, "mxtpu_flash_fwd_plain_calls"));
  if (!launches || !plain) return fail(std::string(argv[1]) + " has no K1 launch counters");
  try {
    if (schema) {
      auto op_handle = c10::Dispatcher::singleton().findSchemaOrThrow("mxtpu::flash_fwd", "");
      std::printf("schema %s\n", c10::toString(op_handle.schema()).c_str());
      return 0;
    }
    return serve(argc - 1, argv + 1, hold, launches, plain);
  } catch (const std::exception& e) {
    return fail(e.what());
  }
}
